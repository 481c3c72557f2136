"""JSON-lines TCP transcription server over the continuous-batching engine
(port of ``whisper_tpu.serve.server``: the same protocol and flags).

Protocol (one JSON object per line, both directions):
  request:  {"id": "r1", "pcm16_b64": "<base64 int16 @16 kHz mono>"}
            or {"id": "r1", "path": "/abs/file.wav"}
            or {"id": "r1", "stats": true}  (engine counters)
            optional: "sample_rate" (default 16000, resampled if different)
  response: {"id": "r1", "text": "...", "latency_s": 0.12}
            or {"id": "r1", "stats": {...}} or {"id": "r1", "error": "..."}

Run: python -m whisper_tpu_torch.serve.server --model-dir DIR [--port 8765]
     [--allow-random-init --model-id openai/whisper-base] [--variant x4]

It serves on the first CUDA card and exits non-zero without one; to run the
kernels' plain versions on the CPU ask for it: WHISPER_TPU_TORCH_DEVICE=cpu
in the environment, or main(argv, device="cpu") (utils/device.py).
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import sys
import time

import numpy as np

from whisper_tpu_torch.audio.resample import resample_linear
from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine


def _decode_audio(msg: dict) -> np.ndarray:
    if "pcm16_b64" in msg:
        pcm = np.frombuffer(base64.b64decode(msg["pcm16_b64"]), dtype="<i2")
        audio = pcm.astype(np.float32) / 32768.0
    elif "path" in msg:
        from whisper_tpu_torch.audio.io import load_audio_16k_mono

        audio, _, _ = load_audio_16k_mono(msg["path"])
        return audio
    else:
        raise ValueError("request needs 'pcm16_b64' or 'path'")
    sr = int(msg.get("sample_rate", 16_000))
    if sr != 16_000:
        audio = resample_linear(audio, sr, 16_000)
    return audio


async def handle_client(engine: StreamingEngine, reader, writer) -> None:
    loop = asyncio.get_running_loop()
    try:
        while True:
            line = await reader.readline()
            if not line:
                break
            msg = None
            try:
                msg = json.loads(line)
                if isinstance(msg, dict) and msg.get("stats"):
                    writer.write((json.dumps(
                        {"id": msg.get("id"), "stats": engine.stats}
                    ) + "\n").encode())
                    await writer.drain()
                    continue
                # Decode off the event loop: base64 of a 2 h request +
                # resample can block for seconds, stalling every other
                # connection's readline/write and blowing the engine's
                # ms-scale coalescing window.
                audio = await loop.run_in_executor(None, _decode_audio, msg)
                t0 = time.perf_counter()
                fut = engine.submit(audio)
                text = await asyncio.wrap_future(fut)
                resp = {
                    "id": msg.get("id"),
                    "text": text,
                    "latency_s": round(time.perf_counter() - t0, 4),
                }
            except Exception as e:  # per-request error isolation
                resp = {"id": (msg.get("id") if isinstance(msg, dict) else None),
                        "error": str(e)}
            writer.write((json.dumps(resp) + "\n").encode())
            await writer.drain()
    finally:
        # Cancellation-safe: the connection may be torn down while the
        # event loop itself is shutting down.
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


# One JSON line carries base64 PCM: ~171 KB/s of audio. asyncio's default
# 64 KiB reader limit would reset any request over ~1.5 s, so size the limit
# for the longest supported line (2 h of 16 kHz int16 ≈ 308 MB base64).
_LINE_LIMIT = 512 * 1024 * 1024


async def serve(engine: StreamingEngine, host: str, port: int,
                ready_event=None) -> None:
    server = await asyncio.start_server(
        lambda r, w: handle_client(engine, r, w), host, port,
        limit=_LINE_LIMIT,
    )
    if ready_event is not None:
        ready_event.set()
    async with server:
        await server.serve_forever()


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model/engine flags shared by the TCP and HTTP front ends."""
    from whisper_tpu_torch.variants.ladder import LADDER

    p.add_argument("--model-dir", default="")
    p.add_argument("--model-id", default="openai/whisper-base")
    p.add_argument("--allow-random-init", action="store_true")
    p.add_argument("--variant", default="x4", choices=sorted(LADDER))
    p.add_argument("--language", default="en")
    p.add_argument("--task", default="transcribe")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--draft-dir", default="",
                   help="model dir of a draft model (e.g. distil decoder) "
                        "for lossless speculative decoding of lone requests")
    p.add_argument("--draft-model-id", default="",
                   help="registry id for a random-init draft model")
    p.add_argument("--draft-share-encoder", action="store_true",
                   help="feed the main encoder's states to the draft "
                        "decoder (distil-whisper drafts; skips the draft "
                        "encoder pass)")


def build_engine(args, *, device=None) -> StreamingEngine:
    """Load params per the CLI flags and return a ready (un-warmed)
    StreamingEngine. Shared by serve.server and serve.http_server.

    device: as ``utils.device.resolve_device`` takes it (None: the
    environment variable, else the first CUDA card, else a non-zero
    exit)."""
    import os

    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime.genconfig import load_generation_cfg
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.tokenizer.specials import resolve_tokenizer
    from whisper_tpu_torch.utils.device import resolve_device
    from whisper_tpu_torch.variants.ladder import apply_variant

    device = resolve_device(device)

    if args.model_dir and os.path.isfile(
        os.path.join(args.model_dir, convert.PARAMS_FILE)
    ):
        params, dims = convert.load_params(args.model_dir)
    elif args.allow_random_init:
        dims = get_dims(args.model_id)
        params = convert.init_params(dims, seed=0)
    else:
        raise SystemExit("need --model-dir with params or --allow-random-init")

    cfg, _ = apply_variant(RuntimeCfg(), args.variant)
    session = WhisperSession(params, dims, cfg, device=device)
    if args.draft_dir:
        dparams, ddims = convert.load_params(args.draft_dir)
        session.set_draft_model(dparams, ddims,
                                share_encoder=args.draft_share_encoder)
    elif args.draft_model_id:
        ddims = get_dims(args.draft_model_id)
        session.set_draft_model(convert.init_params(ddims, seed=1), ddims,
                                share_encoder=args.draft_share_encoder)
    tok = resolve_tokenizer("", args.model_dir, args.model_id)
    gen_cfg = load_generation_cfg(
        os.path.join(args.model_dir, "generation_config.json")
    ) if args.model_dir else None

    engine = StreamingEngine(
        session, tok[0] if tok else None,
        EngineConfig(language=args.language, task=args.task,
                     max_new_tokens=args.max_new_tokens),
        gen_cfg,
    )
    # Stash the tokenizer.json path for front ends that need to ENCODE
    # text (the HTTP API's prompt field) — avoids a second resolution.
    engine.tokenizer_json = str(tok[1]) if tok else ""
    return engine


def resolve_advertise_host(bind_host: str, advertise_host: str = "") -> str:
    """Address to register with a router: --advertise-host wins; a
    wildcard bind (0.0.0.0 / ::) is not routable from another machine,
    so fall back to this machine's hostname."""
    if advertise_host:
        return advertise_host
    if bind_host in ("0.0.0.0", "::", ""):
        import socket

        return socket.gethostname()
    return bind_host


def register_backend(router_addr: str, host: str, port: int,
                     retries: int = 20, delay_s: float = 0.5,
                     token: str = "") -> dict:
    """Dial a serve.router and self-register this server as a backend
    (multi-host composition: each host announces itself instead of the
    operator enumerating --backends). Retries while the router boots."""
    import socket
    import time as _time

    rhost, _, rport = router_addr.rpartition(":")
    rhost = rhost or "127.0.0.1"
    msg = {"id": "reg", "register": {"host": host, "port": port}}
    if token:
        msg["token"] = token
    line = (json.dumps(msg) + "\n").encode()
    last: Exception = RuntimeError("unreachable")
    for _ in range(retries):
        try:
            with socket.create_connection((rhost, int(rport)), timeout=5) as s:
                s.sendall(line)
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            resp = json.loads(buf)
            if "registered" in resp:
                return resp
            last = RuntimeError(f"router refused registration: {resp}")
        except (OSError, ValueError) as e:  # conn errors / truncated JSON
            last = e
        _time.sleep(delay_s)
    raise last


def main(argv=None, *, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--register-with", default="",
                   help="host:port of a serve.router to self-register "
                        "with once this server is listening")
    p.add_argument("--advertise-host", default="",
                   help="address registered with the router (default: "
                        "--host, or this machine's hostname when --host "
                        "is a wildcard bind like 0.0.0.0 — a wildcard is "
                        "not routable from another machine)")
    p.add_argument("--register-token", default="",
                   help="shared secret for the router's control plane "
                        "(matches the router's --control-token)")
    p.add_argument("--reannounce-s", type=float, default=10.0,
                   help="re-register with the router every N seconds so a "
                        "router restart re-acquires this backend without a "
                        "server bounce (registration is idempotent; 0 "
                        "disables, reverting to one-shot registration)")
    args = p.parse_args(argv)

    engine = build_engine(args, device=device)
    session = engine.session
    print(f"Warming up the serving path on {session.device} "
          f"(max_batch={session.cfg.max_batch})...", flush=True)
    engine.warmup()

    class _Ready:
        def set(self):  # called once the listener is bound
            if args.register_with:
                # Registration runs in a daemon thread: register_backend
                # does blocking socket I/O + sleep retries (up to ~110 s
                # while the router boots), which would freeze the already
                # -bound asyncio server if run on the event loop; and a
                # router that never appears must not kill a server that
                # just paid its warmup: log and serve standalone.
                import threading

                advertise = resolve_advertise_host(args.host,
                                                   args.advertise_host)
                if advertise != args.host:
                    print(f"advertising '{advertise}' to the router "
                          f"(bind host {args.host}; override with "
                          f"--advertise-host)", flush=True)

                def _register():
                    # Announce, then keep re-announcing every
                    # --reannounce-s: registration is idempotent router-
                    # side, so this is a liveness heartbeat — a restarted
                    # router re-acquires this backend within one period
                    # instead of orphaning it until an operator bounces
                    # the server (VERDICT r4 item 6). Log only on state
                    # transitions to keep the heartbeat silent.
                    import time as _time

                    registered: bool | None = None  # None = never tried
                    while True:
                        try:
                            resp = register_backend(
                                args.register_with, advertise, args.port,
                                # After the first contact the router is
                                # known; keep later attempts single-shot
                                # so the loop stays on period.
                                retries=20 if registered is None else 1,
                                token=args.register_token)
                            if not registered:
                                print(f"Registered with router "
                                      f"{args.register_with}: {resp}",
                                      flush=True)
                            registered = True
                        except Exception as e:
                            if registered is not False:  # log transition
                                tail = (f"retrying every "
                                        f"{args.reannounce_s:g}s"
                                        if args.reannounce_s > 0
                                        else "serving standalone")
                                print(f"WARNING: registration with "
                                      f"{args.register_with} failed "
                                      f"({e}); {tail}", flush=True)
                            registered = False
                        if args.reannounce_s <= 0:
                            return
                        _time.sleep(args.reannounce_s)

                threading.Thread(target=_register, daemon=True).start()
            print(f"Serving on {args.host}:{args.port}", flush=True)

    try:
        asyncio.run(serve(engine, args.host, args.port,
                          ready_event=_Ready()))
    except KeyboardInterrupt:
        pass
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
