"""Multi-host serving composition on the port (a copy of
tests/test_multihost_serve.py with ``whisper_tpu_torch.serve``).

Two REAL server processes of the port, each its own engine on the CPU
(``WHISPER_TPU_TORCH_DEVICE=cpu``; whisper-tiny with random weights, whose
vocabulary holds the special tokens the engine prompts with), self-register
with the port's router via `--register-with` (no static --backends list),
and concurrent requests driven through the router land on BOTH hosts with
aggregate accounting; a restarted router re-acquires both.
"""

import base64
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.slow


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ask(port: int, req: dict, timeout=120) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def test_two_process_router_composition():
    import asyncio

    from whisper_tpu_torch.serve.router import serve_router

    rport = _free_port()
    loop_holder = {}

    def start_router():
        """Start (or restart, same port) the router thread; returns once
        it is accepting."""
        ready = threading.Event()

        def run_router():
            async def main():
                class Ev:
                    def set(self):
                        ready.set()

                loop_holder["loop"] = asyncio.get_running_loop()
                await serve_router([], "127.0.0.1", rport, Ev())

            try:
                asyncio.run(main())
            except RuntimeError:
                pass  # loop.stop() during teardown cancels serve_forever

        t = threading.Thread(target=run_router, daemon=True)
        t.start()
        assert ready.wait(10)
        return t

    def stop_router(t):
        loop = loop_holder.get("loop")
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=10)

    rt = start_router()

    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO, "WHISPER_TPU_TORCH_DEVICE": "cpu",
                "OMP_NUM_THREADS": "2"})
    ports = [_free_port(), _free_port()]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "whisper_tpu_torch.serve.server",
             "--allow-random-init", "--model-id", "openai/whisper-tiny",
             "--variant", "x2", "--max-new-tokens", "4",
             "--port", str(p), "--register-with", f"127.0.0.1:{rport}",
             "--reannounce-s", "1"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for p in ports
    ]
    try:
        # Self-registration is the readiness signal: poll the router's
        # merged stats until both hosts appear.
        deadline = time.time() + 300
        while time.time() < deadline:
            if all(p.poll() is None for p in procs):
                try:
                    stats = _ask(rport, {"id": "s", "stats": True},
                                 timeout=10)["stats"]
                    if len(stats.get("backends", {})) == 2:
                        break
                except OSError:
                    pass
            else:
                dead = [i for i, p in enumerate(procs) if p.poll() is not None]
                out = procs[dead[0]].stdout.read()
                raise AssertionError(f"server {dead[0]} died:\n{out[-3000:]}")
            time.sleep(1.0)
        else:
            raise AssertionError("backends never registered")

        rng = np.random.default_rng(0)
        n_req = 8
        out = {}

        def client(i):
            pcm = (np.clip(rng.normal(0, 0.1, 16000), -1, 1) * 32767
                   ).astype("<i2")
            out[i] = _ask(rport, {
                "id": f"r{i}",
                "pcm16_b64": base64.b64encode(pcm.tobytes()).decode(),
            })

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_req)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)

        assert set(out) == set(range(n_req))
        for i, resp in out.items():
            assert resp["id"] == f"r{i}", resp
            assert "text" in resp and "error" not in resp, resp

        stats = _ask(rport, {"id": "s2", "stats": True})["stats"]
        per = stats["backends"]
        assert len(per) == 2
        served = {name: b["router_served"] for name, b in per.items()}
        # Aggregate accounting across hosts: all requests accounted for,
        # and least-outstanding dispatch spread them over BOTH hosts.
        assert sum(served.values()) >= n_req
        assert all(v >= 1 for v in served.values()), served

        # --- router restart mid-operation: a fresh
        # router on the same port starts with an EMPTY pool; the servers'
        # periodic re-announce (--reannounce-s 1) must re-acquire both
        # backends without any server bounce, and traffic must flow again.
        stop_router(rt)
        rt = start_router()
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                stats = _ask(rport, {"id": "s3", "stats": True},
                             timeout=10)["stats"]
                if len(stats.get("backends", {})) == 2:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        else:
            raise AssertionError(
                "backends never re-registered after router restart")
        pcm = (np.clip(rng.normal(0, 0.1, 16000), -1, 1) * 32767
               ).astype("<i2")
        resp = _ask(rport, {
            "id": "post-restart",
            "pcm16_b64": base64.b64encode(pcm.tobytes()).decode(),
        })
        assert resp["id"] == "post-restart"
        assert "text" in resp and "error" not in resp, resp
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        loop = loop_holder.get("loop")
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
