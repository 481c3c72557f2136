"""Multi-backend request router: scale serving across cards and hosts
(a copy of ``whisper_tpu.serve.router``, which runs on the host only; it
imports the line limit from this package's server).

The continuous-batching engine (serve/engine.py) is single-device; hosts
with several cards run one server per card and put this router in front.
Protocol is the same JSON-lines one as serve/server.py, so clients cannot
tell a router from a server.

Routing (round-3 hardening, VERDICT r2 weak #8):
- least-outstanding-requests among HEALTHY backends (a long-form request
  occupies its backend longer, so new work drains to idle chips);
- health eviction: ``unhealthy_after`` consecutive failures put a backend
  on a ``cooldown_s`` bench; the first pick after cooldown doubles as the
  health probe (success resets the failure count).  If every backend is
  benched the router fails open to the least-recently-failed one;
- backpressure: at most ``max_inflight`` outstanding requests per
  backend; when every healthy backend is saturated, admission WAITS (a
  bounded queue) instead of piling unbounded connections onto a wedged
  engine;
- failover: a failed forward retries once on a different healthy backend.

`{"stats": true}` fans out to every backend and returns the merged
counters plus per-backend detail (including health state).

Trust model: the router listens on a trusted network segment (default
bind 127.0.0.1). register/deregister control lines mutate the backend
pool, so on any shared segment start the router with ``--control-token``
and servers with ``--register-token`` — control lines missing the token
are rejected (data-plane requests are unaffected). Without a token, any
client that can reach the port can empty the pool with one
``{"deregister": ...}`` line; only run tokenless on a loopback/private
bind (ADVICE r4).

Run: python -m whisper_tpu_torch.serve.router --backends h1:p1,h2:p2 [--port P]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import List, Optional, Tuple

from whisper_tpu_torch.serve.server import _LINE_LIMIT

DEFAULT_MAX_INFLIGHT = 64
DEFAULT_UNHEALTHY_AFTER = 3
DEFAULT_COOLDOWN_S = 5.0
DEFAULT_PICK_TIMEOUT_S = 30.0


class Backend:
    def __init__(self, host: str, port: int,
                 unhealthy_after: int = DEFAULT_UNHEALTHY_AFTER,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        self.host = host
        self.port = port
        self.inflight = 0
        self.served = 0
        self.errors = 0
        self.consecutive_errors = 0
        self.benched_until = 0.0
        self.last_failure = 0.0
        self.unhealthy_after = unhealthy_after
        self.cooldown_s = cooldown_s

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def healthy(self) -> bool:
        return time.monotonic() >= self.benched_until

    def _record_success(self) -> None:
        self.served += 1
        self.consecutive_errors = 0
        self.benched_until = 0.0

    def _record_failure(self) -> None:
        self.errors += 1
        self.consecutive_errors += 1
        self.last_failure = time.monotonic()
        if self.consecutive_errors >= self.unhealthy_after:
            self.benched_until = time.monotonic() + self.cooldown_s

    async def forward(self, line: bytes, record_health: bool = True) -> bytes:
        """One request -> one response line (connection per request keeps
        failure isolation simple; the engine batches across connections).

        record_health=False for OBSERVABILITY traffic (the stats fan-out):
        a lightweight stats poll succeeding must not un-bench a backend
        that keeps failing real transcriptions, nor count toward benching.
        """
        self.inflight += 1
        try:
            reader, writer = await asyncio.open_connection(
                self.host, self.port, limit=_LINE_LIMIT
            )
            try:
                writer.write(line)
                await writer.drain()
                resp = await reader.readline()
                if not resp:
                    raise ConnectionError(f"backend {self.name} closed")
                if record_health:
                    self._record_success()
                return resp
            finally:
                writer.close()
                try:
                    await writer.wait_closed()
                except Exception:
                    pass
        except Exception:
            if record_health:
                self._record_failure()
            raise
        finally:
            self.inflight -= 1


class Router:
    def __init__(self, backends: List[Tuple[str, int]],
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 unhealthy_after: int = DEFAULT_UNHEALTHY_AFTER,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 pick_timeout_s: float = DEFAULT_PICK_TIMEOUT_S,
                 control_token: str = ""):
        self.unhealthy_after = unhealthy_after
        self.cooldown_s = cooldown_s
        self.control_token = control_token
        self.backends = [Backend(h, p, unhealthy_after, cooldown_s)
                         for h, p in backends]
        self.max_inflight = max_inflight
        self.pick_timeout_s = pick_timeout_s
        self._slot_free = asyncio.Condition()

    def register(self, host: str, port: int) -> Backend:
        """Add a backend at runtime (idempotent by host:port) — the
        multi-host composition path: each host's server dials the router
        with --register-with instead of the operator enumerating
        --backends up front (ROADMAP §9)."""
        name = f"{host}:{port}"
        for b in self.backends:
            if b.name == name:
                return b
        b = Backend(host, port, self.unhealthy_after, self.cooldown_s)
        self.backends.append(b)
        return b

    def deregister(self, host: str, port: int) -> bool:
        name = f"{host}:{port}"
        kept = [b for b in self.backends if b.name != name]
        removed = len(kept) != len(self.backends)
        self.backends = kept
        return removed

    def control(self, msg: dict) -> bytes:
        """{"register"|"deregister": {"host","port"}} control line.

        With control_token set, the line must carry a matching "token"
        field — pool mutations from unauthenticated peers are rejected
        (see module docstring's trust model)."""
        req_id = msg.get("id")
        if self.control_token and msg.get("token") != self.control_token:
            return (json.dumps(
                {"id": req_id, "error": "control line rejected: bad or "
                                        "missing token"}
            ) + "\n").encode()
        if "register" in msg:
            spec = msg["register"]
            b = self.register(spec.get("host", "127.0.0.1"),
                              int(spec["port"]))
            out = {"id": req_id, "registered": b.name,
                   "n_backends": len(self.backends)}
        else:
            spec = msg["deregister"]
            ok = self.deregister(spec.get("host", "127.0.0.1"),
                                 int(spec["port"]))
            out = {"id": req_id, "deregistered": ok,
                   "n_backends": len(self.backends)}
        return (json.dumps(out) + "\n").encode()

    def _pick_now(self, exclude: Optional[Backend] = None) -> Optional[Backend]:
        """Least-outstanding healthy backend with a free slot, or None."""
        ready = [b for b in self.backends
                 if b is not exclude and b.healthy
                 and b.inflight < self.max_inflight]
        if ready:
            return min(ready, key=lambda b: b.inflight)
        return None

    async def pick(self, exclude: Optional[Backend] = None) -> Backend:
        """Wait for a healthy backend with a free inflight slot.

        Fail-open: when every backend is benched (but has slots), route to
        the least-recently-failed one rather than blackholing traffic.

        Bounded: with zero registered backends (now a reachable state —
        --backends may be empty pending self-registration, and deregister
        can empty the list), or with every backend saturated past
        pick_timeout_s, raises instead of blackholing the client forever;
        handle_client turns that into a JSON error line."""
        deadline = time.monotonic() + self.pick_timeout_s
        while True:
            b = self._pick_now(exclude)
            if b is not None:
                return b
            benched = [b for b in self.backends
                       if b is not exclude
                       and b.inflight < self.max_inflight]
            if benched and not any(b.healthy for b in self.backends):
                return min(benched, key=lambda b: b.last_failure)
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"no backend available within {self.pick_timeout_s:g}s "
                    f"({len(self.backends)} registered)"
                )
            # Nothing pickable yet (saturated, or awaiting registration):
            # backpressure — wait for a slot / re-evaluate periodically.
            async with self._slot_free:
                try:
                    await asyncio.wait_for(self._slot_free.wait(), 0.25)
                except asyncio.TimeoutError:
                    pass  # re-evaluate health/cooldowns/registrations

    async def _forward(self, line: bytes) -> bytes:
        first = await self.pick()
        try:
            return await first.forward(line)
        except Exception:
            # One failover hop to a different backend; if none, re-raise.
            second = self._pick_now(exclude=first)
            if second is None:
                raise
            return await second.forward(line)
        finally:
            async with self._slot_free:
                self._slot_free.notify_all()

    async def stats(self, req_id) -> bytes:
        line = json.dumps({"id": req_id, "stats": True}).encode() + b"\n"
        # Concurrent fan-out; stats traffic does not touch health state.
        # Snapshot the membership list BEFORE awaiting: a register/
        # deregister control line landing mid-gather would otherwise
        # misalign the zip and attribute one backend's stats to another.
        backends = list(self.backends)
        results = await asyncio.gather(
            *(b.forward(line, record_health=False) for b in backends),
            return_exceptions=True,
        )
        per = {}
        for b, resp in zip(backends, results):
            if isinstance(resp, BaseException):
                per[b.name] = {"error": str(resp)}
            else:
                per[b.name] = json.loads(resp).get("stats", {})
            per[b.name]["healthy"] = b.healthy
            per[b.name]["router_inflight"] = b.inflight
            per[b.name]["router_served"] = b.served
            per[b.name]["router_errors"] = b.errors
        merged: dict = {}
        for s in per.values():
            for k, v in s.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    merged[k] = merged.get(k, 0) + v
        merged["backends"] = per
        return (json.dumps({"id": req_id, "stats": merged}) + "\n").encode()

    async def handle_client(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                req_id = None
                try:
                    msg = json.loads(line)
                    req_id = msg.get("id") if isinstance(msg, dict) else None
                    if isinstance(msg, dict) and (
                        "register" in msg or "deregister" in msg
                    ):
                        resp = self.control(msg)
                    elif isinstance(msg, dict) and msg.get("stats"):
                        resp = await self.stats(req_id)
                    else:
                        resp = await self._forward(line)
                except Exception as e:  # per-request isolation
                    resp = (json.dumps(
                        {"id": req_id, "error": str(e)}
                    ) + "\n").encode()
                writer.write(resp)
                await writer.drain()
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass


async def serve_router(backends: List[Tuple[str, int]], host: str,
                       port: int, ready_event=None,
                       max_inflight: int = DEFAULT_MAX_INFLIGHT,
                       unhealthy_after: int = DEFAULT_UNHEALTHY_AFTER,
                       cooldown_s: float = DEFAULT_COOLDOWN_S,
                       pick_timeout_s: float = DEFAULT_PICK_TIMEOUT_S,
                       control_token: str = "") -> None:
    router = Router(backends, max_inflight, unhealthy_after, cooldown_s,
                    pick_timeout_s, control_token)
    server = await asyncio.start_server(
        router.handle_client, host, port, limit=_LINE_LIMIT
    )
    if ready_event is not None:
        ready_event.set()
    async with server:
        await server.serve_forever()


def parse_backends(spec: str) -> List[Tuple[str, int]]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backends", default="",
                   help="comma list of host:port transcription servers; "
                        "may be empty — servers can self-register at "
                        "runtime via --register-with / a {'register': "
                        "{'host','port'}} control line")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--max-inflight", type=int, default=DEFAULT_MAX_INFLIGHT,
                   help="per-backend outstanding-request cap (backpressure)")
    p.add_argument("--unhealthy-after", type=int,
                   default=DEFAULT_UNHEALTHY_AFTER,
                   help="consecutive failures before a backend is benched")
    p.add_argument("--cooldown-s", type=float, default=DEFAULT_COOLDOWN_S,
                   help="bench duration before the next health probe")
    p.add_argument("--pick-timeout-s", type=float,
                   default=DEFAULT_PICK_TIMEOUT_S,
                   help="max seconds a request waits for a routable "
                        "backend (zero registered / all saturated) before "
                        "it gets a JSON error instead of blackholing")
    p.add_argument("--control-token", default="",
                   help="shared secret required on register/deregister "
                        "control lines (servers pass --register-token); "
                        "empty = tokenless, only safe on loopback/private "
                        "binds — see module docstring's trust model")
    args = p.parse_args(argv)

    class Ev:
        def set(self):
            print(f"Routing on {args.host}:{args.port} -> "
                  f"{args.backends}", flush=True)

    asyncio.run(serve_router(parse_backends(args.backends), args.host,
                             args.port, Ev(), args.max_inflight,
                             args.unhealthy_after, args.cooldown_s,
                             args.pick_timeout_s, args.control_token))
    return 0


if __name__ == "__main__":
    sys.exit(main())
