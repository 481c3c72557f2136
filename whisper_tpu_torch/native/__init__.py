"""Host-side native code of the port: the libav audio decoder
(``audio_native``), built from ``audio_decode.cc`` at first use."""
