from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine

__all__ = ["StreamingEngine", "EngineConfig"]
