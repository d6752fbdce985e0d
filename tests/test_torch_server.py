"""The port's HTTP shim (``repro_torch/launch/server.py``) and router load
test (``repro_torch/launch/loadtest.py``) on the CPU:

* the shim on an ephemeral port over a reduced-config router: a streamed
  ``/v1/generate`` gives the tokens ``handle.result()`` gives the same
  prompt; 413 for a request that never fits, 429 with ``Retry-After``
  for a full queue, 400 for a malformed body, 404 for an unknown path;
  ``/healthz`` 200, then 503 (and generate 503) while draining, with the
  live stream still completing; ``/stats`` as JSON;
* ``make_trace`` equal to the reference's ``benchmarks.loadtest``
  trace for seeds 0-3 (times, prompts, budgets, priorities, deadlines,
  disconnects, the shared prefix);
* ``run_loadtest(smoke=True, reduced=True, device='cpu')`` holding its
  invariants (every request terminal, no live page after a drain, chaos
  ok-vs-plain ok bitwise but for the requests a page flip hit, prefix
  hits), its legs in order through ``around_leg``, and each leg's
  results in ``legs``.
"""
import pytest

torch = pytest.importorskip("torch")

import asyncio  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.server import HttpFrontend  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.router import Router  # noqa: E402

KN = dict(seg_len=2, kv="int8", page_size=4, buckets=(4, 8), chunk_len=4,
          max_prompt=24, max_new_cap=48, device="cpu", log=lambda *a: None)


@pytest.fixture(scope="module")
def model():
    cfg = get_arch("qwen3-0.6b").reduced()
    return cfg, lm.init_params(cfg, 0, device="cpu")


async def _http(port, method, path, body=None):
    """One request; returns (status, headers, body bytes de-chunked)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else (body if isinstance(body, bytes)
                                     else json.dumps(body).encode())
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = {k.strip().lower(): v.strip() for k, v in
               (ln.split(":", 1) for ln in lines[1:])}
    if headers.get("transfer-encoding") == "chunked":
        out = b""
        while True:
            size, _, rest = rest.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, rest = out + rest[:n], rest[n + 2:]
        rest = out
    return status, headers, rest


def _ndjson(body):
    return [json.loads(ln) for ln in body.decode().splitlines() if ln]


def test_http_shim_codes_and_stream(model):
    cfg, params = model
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 120, 6).astype(np.int32)

    async def run():
        router = Router(cfg, params, slots=2, **KN)
        front = HttpFrontend(router, "127.0.0.1", 0, log=lambda *a: None)
        task = asyncio.create_task(front.serve())
        _, port = await front.wait_ready()
        got = {}
        got["health"] = await _http(port, "GET", "/healthz")
        got["gen"] = await _http(port, "POST", "/v1/generate",
                                 {"prompt": prompt.tolist(), "max_new": 7})
        got["direct"] = await router.submit(prompt, 7).result()
        got["413"] = await _http(port, "POST", "/v1/generate",
                                 {"prompt": [1] * 40, "max_new": 4})
        got["400"] = await _http(port, "POST", "/v1/generate", b"{not json")
        got["400b"] = await _http(port, "POST", "/v1/generate",
                                  {"max_new": 4})
        got["404"] = await _http(port, "GET", "/nope")
        got["stats"] = await _http(port, "GET", "/stats")
        # a long live stream, then the drain: healthz and generate 503
        # while it finishes
        long = asyncio.create_task(_http(
            port, "POST", "/v1/generate",
            {"prompt": prompt[:4].tolist(), "max_new": 48}))
        while router.stats()["completed"] < 2 or not any(
                r >= 0 for r in router._host["slot_rid"]):
            await asyncio.sleep(0.001)
        front.request_drain()
        got["health_drain"] = await _http(port, "GET", "/healthz")
        got["gen_drain"] = await _http(port, "POST", "/v1/generate",
                                       {"prompt": [1, 2, 3, 4],
                                        "max_new": 2})
        got["long"] = await long
        await task
        got["final"] = router.stats()
        return got

    got = asyncio.run(run())
    assert got["health"][0] == 200
    assert json.loads(got["health"][2]) == {"ok": True, "draining": False}
    status, headers, body = got["gen"]
    assert status == 200 and headers["content-type"] == "application/x-ndjson"
    events = _ndjson(body)
    assert events[-1] == {"status": "ok"}
    tokens = [e["token"] for e in events[:-1]]
    assert got["direct"].status == "ok" and tokens == got["direct"].tokens
    assert len(tokens) == 7
    assert got["413"][0] == 413
    assert json.loads(got["413"][2])["reason"] == "too_large"
    assert got["400"][0] == 400 and got["400b"][0] == 400
    assert got["404"][0] == 404
    assert got["stats"][0] == 200
    assert json.loads(got["stats"][2])["statuses"] == {"ok": 2}
    assert got["health_drain"][0] == 503
    assert json.loads(got["health_drain"][2])["draining"] is True
    assert got["gen_drain"][0] == 503
    assert json.loads(got["gen_drain"][2])["reason"] == "draining"
    long = _ndjson(got["long"][2])
    assert long[-1] == {"status": "ok"} and len(long) == 49
    assert got["final"]["pages"]["live_pages"] == 0


def test_http_shim_queue_refusal_is_429_with_retry_after(model):
    """A full admission queue (here a router that queues nothing) answers
    429 with a Retry-After of at least a second, before any body
    streams."""
    cfg, params = model

    async def run():
        router = Router(cfg, params, slots=1, max_queue=0, **KN)
        front = HttpFrontend(router, "127.0.0.1", 0, log=lambda *a: None)
        task = asyncio.create_task(front.serve())
        _, port = await front.wait_ready()
        out = await _http(port, "POST", "/v1/generate",
                          {"prompt": [1, 2, 3, 4], "max_new": 2})
        front.request_drain()
        await task
        return out, router.stats()

    (status, headers, body), stats = asyncio.run(run())
    assert status == 429 and int(headers["retry-after"]) >= 1
    assert json.loads(body)["reason"] == "queue"
    assert stats["refusals"]["queue"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_make_trace_equals_reference(seed):
    from benchmarks.loadtest import make_trace as jmake_trace
    from repro_torch.launch.loadtest import make_trace

    sysp = np.random.default_rng(seed + 3).integers(1, 1000, 8,
                                                    dtype=np.int32)
    for kw in (dict(buckets=(4, 8), max_prompt=12, max_new_cap=8),
               dict(buckets=(32, 64), max_prompt=96, max_new_cap=16,
                    mean_gap_s=0.002, shared_prefix=sysp,
                    shared_frac=0.75)):
        got = make_trace(seed, 64, **kw)
        want = jmake_trace(seed, 64, **kw)
        assert len(got) == len(want) == 64
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                if k == "prompt":
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k


def test_loadtest_smoke_holds_its_invariants():
    from repro_torch.launch.loadtest import run_loadtest

    legs, entered = {}, []

    def around(name):
        entered.append(name)
        return contextlib.nullcontext()

    rows, plain, chaos = run_loadtest(smoke=True, reduced=True, prefix=True,
                                      device="cpu", log=lambda *a: None,
                                      around_leg=around, legs=legs)
    assert entered == ["warmup", "plain", "chaos", "prefix_cold",
                       "prefix_warm"]
    assert legs["plain"]["metrics"] == plain
    assert legs["chaos"]["metrics"] == chaos
    ck = legs["checks"]
    assert ck["chaos_bitwise"] > 0 and ck["prefix_bitwise"] > 0
    assert "direct" not in ck          # the smoke shape skips the replay
    assert [r["name"].split("/")[1] for r in rows] == [
        "router_plain", "router_chaos", "prefix_router"]
    for m in (plain, chaos):
        assert sum(m["statuses"].values()) == m["requests"] == 24
        assert m["pages"]["live_pages"] == 0
        assert m["statuses"]["ok"] > 0
    assert chaos["replays"] >= 1 and plain["replays"] == 0
    assert "hits=" in rows[2]["derived"]
