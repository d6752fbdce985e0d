"""Thin HTTP shim over the asyncio serving router (port of
``repro/launch/server.py``; runtime/router.py is the product, this file
maps its typed surface onto the wire).

    python -m repro_torch.launch.server --dscim kernel:dscim1:256

serves ``--arch`` (any registered token-input config, default
qwen3-0.6b) at its published width on the GPU (``--reduced`` cuts it to
the smoke-test size, ``--device cpu`` runs the plain PyTorch versions on
the CPU), random weights from seed 0.  Stdlib only
(``asyncio.start_server`` and hand-written HTTP/1.1):

* ``POST /v1/generate``: body ``{"prompt": [ids], "max_new": n,
  "deadline_s"?, "deadline_steps"?, "priority"?}``.  Streams
  newline-delimited JSON (chunked transfer): ``{"token": id}`` per
  generated token, ``{"restart": true}`` when a quarantined request is
  served again down the degradation ladder (the tokens streamed before
  are void), and a final ``{"status": "ok" | "deadline" | "cancelled" |
  "degraded" | "refused"}``.  A ``Refused`` maps to a status code before
  any body streams: 429 with ``Retry-After`` (queue overload), 413 (the
  request can never fit this router), 503 (draining); a malformed body
  gets 400.  A client that disconnects mid-stream cancels its slot.
* ``GET /healthz``: 200 ``{"ok": true, "draining": false}``, 503 while
  draining (so balancers stop routing here).
* ``GET /stats``: the router's stats as JSON.

SIGTERM and SIGINT start a graceful drain: admission answers 503, live
requests stream to completion, then the listener closes.
"""
from __future__ import annotations

import asyncio
import json
import signal

import numpy as np

from ..runtime.router import Refused, Router

__all__ = ["HttpFrontend", "main"]

_REASON_HTTP = {"queue": (429, "Too Many Requests"),
                "too_large": (413, "Payload Too Large"),
                "draining": (503, "Service Unavailable")}


def _resp_head(status: int, phrase: str, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _json_response(status: int, phrase: str, obj) -> bytes:
    body = (json.dumps(obj) + "\n").encode()
    return _resp_head(status, phrase, {
        "Content-Type": "application/json",
        "Content-Length": str(len(body)),
        "Connection": "close"}) + body


async def _read_request(reader) -> tuple[str, str, dict, bytes] | None:
    """Parse one HTTP/1.1 request (method, path, headers, body)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        return None
    lines = head.decode("latin1").split("\r\n")
    try:
        method, path, _ = lines[0].split(" ", 2)
    except ValueError:
        return None
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    body = b""
    n = int(headers.get("content-length", "0") or "0")
    if n:
        body = await reader.readexactly(n)
    return method, path, headers, body


class HttpFrontend:
    """Bind a Router to a TCP listener.  ``await serve()`` runs until a
    drain is requested; ``request_drain()`` (wired to SIGTERM/SIGINT by
    ``main``) starts the graceful shutdown.  ``port=0`` takes a free
    port; ``bound`` holds the (host, port) listened on."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 8080, log=print):
        self.router = router
        self.host = host
        self.port = port
        self.log = log
        self.bound = None
        self._server = None
        self._drain = asyncio.Event()
        self._ready = asyncio.Event()

    def request_drain(self) -> None:
        self._drain.set()

    async def wait_ready(self) -> tuple:
        """The bound (host, port), once the listener accepts."""
        await self._ready.wait()
        return self.bound

    async def _stream_generate(self, writer, body: bytes) -> None:
        try:
            req = json.loads(body.decode() or "{}")
            prompt = np.asarray(req["prompt"], np.int32)
            handle = self.router.submit(
                prompt, int(req.get("max_new", 16)),
                deadline_s=req.get("deadline_s"),
                deadline_steps=req.get("deadline_steps"),
                priority=int(req.get("priority", 0)))
        except Refused as e:
            code, phrase = _REASON_HTTP[e.reason]
            hdr = {"Content-Type": "application/json",
                   "Connection": "close"}
            if e.retry_after is not None:
                hdr["Retry-After"] = str(max(1, int(np.ceil(e.retry_after))))
            body = (json.dumps({"status": "refused", "reason": e.reason,
                                "retry_after": e.retry_after}) + "\n"
                    ).encode()
            hdr["Content-Length"] = str(len(body))
            writer.write(_resp_head(code, phrase, hdr) + body)
            return
        except (KeyError, ValueError, TypeError) as e:
            writer.write(_json_response(400, "Bad Request",
                                        {"error": str(e)}))
            return
        writer.write(_resp_head(200, "OK", {
            "Content-Type": "application/x-ndjson",
            "Transfer-Encoding": "chunked",
            "Connection": "close"}))

        def chunk(obj) -> bytes:
            line = (json.dumps(obj) + "\n").encode()
            return f"{len(line):x}\r\n".encode() + line + b"\r\n"

        try:
            async for kind, val in handle.events():
                if kind == "token":
                    writer.write(chunk({"token": int(val)}))
                elif kind == "restart":
                    writer.write(chunk({"restart": True}))
                else:
                    writer.write(chunk({"status": val}))
                await writer.drain()
            writer.write(b"0\r\n\r\n")
        except (ConnectionResetError, BrokenPipeError):
            handle.cancel()            # client went away: recycle the slot

    async def _handle(self, reader, writer) -> None:
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                return
            method, path, _, body = parsed
            if method == "POST" and path == "/v1/generate":
                await self._stream_generate(writer, body)
            elif method == "GET" and path == "/healthz":
                draining = self.router._draining
                writer.write(_json_response(
                    503 if draining else 200,
                    "Service Unavailable" if draining else "OK",
                    {"ok": not draining, "draining": draining}))
            elif method == "GET" and path == "/stats":
                writer.write(_json_response(200, "OK", self.router.stats()))
            else:
                writer.write(_json_response(404, "Not Found",
                                            {"error": f"no route {path}"}))
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def serve(self) -> None:
        await self.router.start()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.bound = self._server.sockets[0].getsockname()[:2]
        self._ready.set()
        self.log(f"[server] listening on {self.bound[0]}:{self.bound[1]}")
        await self._drain.wait()
        self.log("[server] drain requested: refusing admission, "
                 "finishing live requests")
        await self.router.close("drain")
        self._server.close()
        await self._server.wait_closed()
        self.log(f"[server] drained; final stats: {self.router.stats()}")


def main(argv=None):
    import argparse
    import dataclasses

    from ..configs import CONTINUOUS_ARCHS, get_arch
    from ..configs.base import PAGED_ATTN
    from ..device import resolve_device
    from ..models import lm

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=CONTINUOUS_ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke-test width instead of "
                         "the published one")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--segment-len", type=int, default=4)
    ap.add_argument("--kv", choices=("float", "int8"), default="int8")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--buckets", default="8,16,32", metavar="S1,S2,...",
                    help="one-shot prefill prompt lengths (others chunk)")
    ap.add_argument("--chunk-len", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=256)
    ap.add_argument("--max-new-cap", type=int, default=64)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--dscim", default="off")
    ap.add_argument("--paged-attn", choices=PAGED_ATTN,
                    default="auto",
                    help="the int8 read path (launch/serve.py --paged-attn)")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="failover snapshot cadence in segments (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dscim != "off":
        cfg = dataclasses.replace(cfg, dscim=args.dscim)
    params = lm.init_params(cfg, 0, device=dev)

    async def run():
        router = Router(cfg, params, slots=args.slots,
                        seg_len=args.segment_len, kv=args.kv,
                        page_size=args.page_size,
                        buckets=tuple(int(b) for b in
                                      args.buckets.split(",") if b),
                        chunk_len=args.chunk_len,
                        max_prompt=args.max_prompt,
                        max_new_cap=args.max_new_cap,
                        max_queue=args.max_queue,
                        snapshot_every=args.snapshot_every, device=dev,
                        paged_attn=args.paged_attn)
        front = HttpFrontend(router, args.host, args.port)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, front.request_drain)
        await front.serve()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
