"""paddle_tpu_torch memz (`observability.memz`) and the allocator's ring
hooks against the JAX package's.

  * the same seeded allocation script (alloc / retain / release /
    release_range / retag, exhaustion included) on a JAX and a port
    `PageAllocator` gives, after every operation, the same stats, owner
    rollups, owned pages and fragmentation map, and lands the same
    ``(op, pool, owner, n, free)`` events on each package's memz ring; a
    tiered allocator's spill / refetch commits land the same events too;
  * on that state both packages' memz give the same `/memz` snapshot,
    status block, ghost audit and OOM dump (wall times aside), keep the
    same number of dumps, and merge backend bodies the same way;
  * an exhausted port DecodeEngine leaves an OOM dump that accounts for
    every page (as tests/test_memz.py holds the JAX engine to), served at
    ``/memz?oom=1``.
No sleeps and no overhead bounds."""
import dataclasses
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.memory import migration as jmigration  # noqa: E402
from paddle_tpu.memory import page_allocator as jpa  # noqa: E402
from paddle_tpu.observability import memz as jmemz  # noqa: E402
from paddle_tpu_torch.memory import migration as tmigration  # noqa: E402
from paddle_tpu_torch.memory import page_allocator as tpa  # noqa: E402
from paddle_tpu_torch.observability import memz as tmemz  # noqa: E402

TIMEOUT = 180
OWNERS = [("slot", "r1", "acme"), ("slot", "r2", "blue"), ("trie", "aa11"),
          ("draft", "r3"), ("handoff", "h9"), None]


def _events(memz):
    return [e[:5] for e in memz.RING.snapshot()[0]]


def _apply(alloc, op, arg):
    """One scripted op; returns its result or the exception's facts."""
    try:
        if op == "alloc":
            return alloc.alloc(arg[0], owner=arg[1])
        if op == "retain":
            return alloc.retain(arg[0], owner=arg[1])
        if op == "release":
            return alloc.release(arg[0], owner=arg[1])
        if op == "range":
            return alloc.release_range(arg[0], arg[1], owner=arg[2])
        return alloc.retag(arg[0], arg[1], arg[2])
    except Exception as e:
        return (type(e).__name__, getattr(e, "requested", None),
                getattr(e, "free", None), getattr(e, "owner", None))


def _script(seed, n_ops, num_pages):
    """A seeded op sequence driven by a model of the live pages."""
    rng = np.random.default_rng(seed)
    held = []                  # (page, owner) references the script holds
    out = []
    for _ in range(n_ops):
        r = rng.random()
        owner = OWNERS[int(rng.integers(0, len(OWNERS)))]
        if r < 0.35 or not held:
            n = int(rng.integers(1, num_pages // 3 + 2))
            out.append(("alloc", (n, owner)))
        elif r < 0.5:
            page, _ = held[int(rng.integers(0, len(held)))]
            out.append(("retain", (page, owner)))
        elif r < 0.8:
            page, tag = held.pop(int(rng.integers(0, len(held))))
            out.append(("release", (page, tag)))
        elif r < 0.9:
            k = int(rng.integers(0, len(held)))
            ids = [p for p, _ in held]
            out.append(("range", (ids, k, owner)))
        else:
            k = int(rng.integers(0, len(held)))
            page, tag = held[k]
            new = OWNERS[int(rng.integers(0, len(OWNERS) - 1))]
            held[k] = (page, new)
            out.append(("retag", (page, tag, new)))
        yield out[-1], held


def _drive(seed, n_ops=120, num_pages=17):
    """Run the script on both allocators; returns them."""
    jmemz.RING.clear()
    tmemz.RING.clear()
    ja = jpa.PageAllocator(num_pages, label="twin")
    ta = tpa.PageAllocator(num_pages, label="twin")
    for (op, arg), held in _script(seed, n_ops, num_pages):
        jr, tr = _apply(ja, op, arg), _apply(ta, op, arg)
        assert tr == jr, (op, arg)
        if op == "alloc" and isinstance(tr, list):
            held.extend((p, arg[1]) for p in tr)
        elif op == "retain" and isinstance(tr, int):
            held.append((arg[0], arg[1]))
        elif op == "range" and isinstance(tr, int):
            del held[arg[1]:]
        assert ta.stats() == ja.stats(), (op, arg)
    return ja, ta


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_allocation_script_matches_jax(seed):
    ja, ta = _drive(seed)
    assert sorted(ta.owned_pages()) == sorted(ja.owned_pages())
    assert ta.fragmentation_map() == ja.fragmentation_map()
    assert ta.owner_rollups() == ja.owner_rollups()
    ev = _events(tmemz)
    assert ev == _events(jmemz)
    assert {e[0] for e in ev} >= {"alloc", "release", "exhausted"}
    st = ta.stats()
    assert sum(st["owners"].values()) == st["pages_used"] \
        == sum(st["owner_kinds"].values()) == sum(st["tenants"].values())


def test_tier_commits_land_the_same_ring_events():
    jmemz.RING.clear()
    tmemz.RING.clear()
    out = []
    for mod in (jmigration, tmigration):
        a = mod.TieredPageAllocator(9, host_pages=4)
        hs = a.spill_begin(3)
        for h in hs:
            a.spill_commit(h)
        a.refetch_begin(hs[0])
        a.refetch_commit(hs[0])
        out.append(a.stats())
    assert out[1] == out[0]
    assert _events(tmemz) == _events(jmemz)
    assert [e[0] for e in _events(tmemz)] == ["spill"] * 3 + ["refetch"]


class _Ctx:
    def __init__(self, live):
        self.live = live

    def context(self):
        return {"live_owner_ids": list(self.live), "kv_ladder": [16]}


def _strip(d):
    """An OOM dump or snapshot without its wall times."""
    d = json.loads(json.dumps(d))
    for key in ("time",):
        d.pop(key, None)
    for row in d.get("ring_tail", []) + d.get("ring", {}).get("tail", []):
        row.pop("t", None)
    return d


def test_snapshot_status_ghosts_and_oom_dump_match_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MEMZ_OOM_DUMPS", "2")
    ja, ta = _drive(4, n_ops=80, num_pages=13)
    ctx = _Ctx({"r1"})                       # r2, r3, h9 have finished
    for memz, a in ((jmemz, ja), (tmemz, ta)):
        memz.clear_oom_dumps()
        memz.register_pool(a, context_fn=ctx.context, label="twin")
    js, ts = jmemz.snapshot(), tmemz.snapshot()
    assert _strip(ts)["pools"]["twin"] == _strip(js)["pools"]["twin"]
    assert tmemz.status_block()["pools"]["twin"] == \
        jmemz.status_block()["pools"]["twin"]
    assert tmemz.ghost_audit(ta, ctx.context()) == \
        jmemz.ghost_audit(ja, ctx.context())
    assert tmemz.ghost_audit(ta, None) == []
    dumps = []
    for memz, a in ((jmemz, ja), (tmemz, ta)):
        for i in range(3):
            memz.capture_oom(a, owner=("slot", "r1", "acme"),
                             requested=5 + i, context=ctx.context())
        dumps.append(memz.oom_dumps())
    jd, td = dumps
    assert len(td) == len(jd) == 2          # the retention limit
    assert [_strip(d) for d in td] == [_strip(d) for d in jd]
    d = td[-1]
    assert d["requested"] == 7
    assert sum(d["owner_kinds"].values()) == d["pages_used"] \
        == sum(d["top_owners"].values())
    assert d["pages_used"] + d["pages_free"] == 12
    assert tmemz.snapshot(oom=True)["oom_dumps"] == td
    for memz in (jmemz, tmemz):
        memz.clear_oom_dumps()


def test_merge_memz_matches_jax():
    ja, ta = _drive(5, n_ops=60, num_pages=13)
    bodies = {}
    for name, memz, a in (("jax", jmemz, ja), ("port", tmemz, ta)):
        memz.register_pool(a, label="twin")
        snap = _strip(memz.snapshot())
        snap["pools"] = {"twin": snap["pools"]["twin"]}
        bodies[name] = snap
    for memz in (jmemz, tmemz):
        assert memz.merge_memz([bodies["jax"], None, bodies["port"]],
                               keys=["b0", "b1", "b2"]) == \
            jmemz.merge_memz([bodies["jax"], None, bodies["port"]],
                             keys=["b0", "b1", "b2"])
    m = tmemz.merge_memz([bodies["port"], bodies["port"]])
    assert m["pages_used"] == 2 * ta.stats()["pages_used"]
    oom = [{"oom_dumps": [{"time": 2.0, "seq": 2}]},
           {"oom_dumps": [{"time": 1.0, "seq": 1}]}]
    assert tmemz.merge_memz(oom) == jmemz.merge_memz(oom)
    assert [d["seq"] for d in tmemz.merge_memz(oom)["oom_dumps"]] == [1, 2]


@pytest.mark.parametrize("raw", ["0", "32", "junk"])
def test_ring_capacity_and_dump_limit_env_match_jax(monkeypatch, raw):
    monkeypatch.setenv("PADDLE_TPU_MEMZ_RING_CAPACITY", raw)
    monkeypatch.setenv("PADDLE_TPU_MEMZ_OOM_DUMPS", raw)
    assert tmemz.ring_capacity() == jmemz.ring_capacity()
    assert tmemz.oom_dump_limit() == jmemz.oom_dump_limit()
    ring = tmemz.MemRing()
    ring.record("alloc", "kv", ("slot", "r", "t"), 1, 3)
    assert ring.total == (0 if raw == "0" else 1)


def test_engine_oom_dump_accounts_for_every_page():
    """Exhaust a port DecodeEngine (no prefix cache, no tier): one stream
    holds pages while another asks for more than are left. The dump's
    rollups account for every used page, it embeds the allocation ring,
    names the engine's context, and `/memz?oom=1` serves it."""
    from paddle_tpu.models.gpt import gpt_tiny
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.inference.errors import TypedServeError
    from paddle_tpu_torch.models.gpt import (GPTConfig, init_params_numpy,
                                             params_from_numpy)
    from paddle_tpu_torch.observability import AdminServer
    cfg = GPTConfig(**dataclasses.asdict(gpt_tiny()))
    params = params_from_numpy(cfg, init_params_numpy(cfg, seed=3), "cpu")
    tmemz.clear_oom_dumps()
    eng = DecodeEngine(cfg=cfg, params=params, max_slots=2, page_tokens=4,
                       num_pages=5, prefix_cache=False, device="cpu")
    try:
        with eng._cond:        # both admitted in the same tick, in order
            s1 = eng.submit(list(range(1, 9)), max_new_tokens=3)
            s2 = eng.submit(list(range(9, 21)), max_new_tokens=3)
        with pytest.raises(TypedServeError, match="RESOURCE_EXHAUSTED"):
            s2.result(timeout=TIMEOUT)
        s1.result(timeout=TIMEOUT)
        (d,) = tmemz.oom_dumps()
        assert d["pool"] == eng._alloc.label and d["requested"] == 3
        assert d["denied_owner"].startswith("slot:") \
            and d["denied_owner"].endswith(":default")
        assert sum(d["top_owners"].values()) == d["pages_used"] == 2
        assert sum(d["owner_kinds"].values()) == d["pages_used"]
        assert sum(d["tenants"].values()) == d["pages_used"]
        assert d["pages_used"] + d["pages_free"] == 4
        assert {"alloc", "exhausted"} <= {e["op"] for e in d["ring_tail"]}
        assert d["context"]["page_tokens"] == 4
        with AdminServer(port=0) as adm:
            base = f"http://127.0.0.1:{adm.port}"
            with urllib.request.urlopen(base + "/memz?oom=1",
                                        timeout=10) as r:
                body = json.loads(r.read())
            assert body["oom_dumps"][-1]["seq"] == d["seq"]
            with urllib.request.urlopen(base + "/memz", timeout=10) as r:
                pool = json.loads(r.read())["pools"][eng._alloc.label]
            assert sum(pool["stats"]["owner_kinds"].values()) == \
                pool["stats"]["pages_used"]
            assert pool["ghost_pages"] == 0
    finally:
        eng.stop()
        tmemz.clear_oom_dumps()
