"""paddle_tpu_torch `profiler` against the JAX package's.

  * the same paddle-API code under ``with profiler.profiler()`` gives
    `summary()` rows under the same dispatch names with the same call
    counts in both packages (the port records them at its dispatch choke
    point, ``ops._dispatch.cast_in``; the JAX package in its tape's
    ``apply``); RecordEvent rows, nested and as a decorator, too;
  * the always-on aggregates — `record_compile` / `compile_events`,
    `record_step` / `step_timeline` / `step_timeline_summary`, the
    `record_serve_*` family and `serve_stats` — give the same values for
    the same calls (reqs/s, a wall-clock rate, aside);
  * `start_trace` / `stop_trace` / `trace` write a Chrome trace
    (torch.profiler) holding the RecordEvent spans; `utils.Profiler`,
    `ProfilerOptions` and `get_profiler` behave as the JAX aliases do.
"""
import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu import profiler as jprof  # noqa: E402
from paddle_tpu import utils as jutils  # noqa: E402
from paddle_tpu_torch import profiler as tprof  # noqa: E402
from paddle_tpu_torch import utils as tutils  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tdevice, "_DEFAULT", [torch.device("cpu")])


def _elementwise(p, F, x, y):
    z = p.exp(x * 0.5) + y
    return p.sum(p.abs(z - 1.0))


def _layers(p, F, x, y):
    h = F.relu(p.matmul(x, p.transpose(y, [1, 0])))
    return F.softmax(h, axis=-1).mean()


def _shapes(p, F, x, y):
    c = p.concat([x, y], axis=0)
    r = p.reshape(c, [4, 12])
    return p.argmax(r, axis=1), p.max(r), p.sqrt(p.square(r))


PROGRAMS = {"elementwise": _elementwise, "layers": _layers,
            "shapes": _shapes}


def _rows(prof, p, F, program, capsys):
    rng = np.random.default_rng(0)
    x = p.to_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    y = p.to_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    with prof.profiler(sorted_key="calls"):
        program(p, F, x, y)
    printed = capsys.readouterr().out
    table = prof.summary("calls")
    assert printed.strip() == table.strip()
    return collections.Counter({
        ln.split()[0]: int(ln.split()[1])
        for ln in table.splitlines()[1:]})


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_summary_dispatch_names_match_jax(name, capsys):
    want = _rows(jprof, jpaddle, JF, PROGRAMS[name], capsys)
    got = _rows(tprof, tpaddle, TF, PROGRAMS[name], capsys)
    assert got == want
    assert sum(got.values()) >= 4 and all(k.startswith("op::") for k in got)


def test_record_event_rows_match_jax(capsys):
    tables = []
    for prof, p in ((jprof, jpaddle), (tprof, tpaddle)):
        x = p.to_tensor(np.ones((3, 3), np.float32))

        @prof.RecordEvent("fn_scope")
        def f(a):
            return a + 1

        prof.start_profiler()
        with prof.RecordEvent("outer"):
            with prof.RecordEvent("inner"):
                p.exp(x)
            f(x)
        table = prof.stop_profiler(print_table=False)
        tables.append(collections.Counter({
            ln.split()[0]: int(ln.split()[1])
            for ln in table.splitlines()[1:]}))
        assert not prof.is_profiling()
    assert tables[1] == tables[0]
    assert {"outer", "inner", "fn_scope", "op::exp"} <= set(tables[1])
    # outside a profiling window nothing is recorded
    tprof.start_profiler()
    tprof.stop_profiler(print_table=False)
    tpaddle.exp(tpaddle.to_tensor([1.0]))
    assert tprof.summary().splitlines()[1:] == []


def test_always_on_aggregates_match_jax():
    out = []
    for prof in (jprof, tprof):
        prof.reset_compile_events()
        prof.reset_step_timeline()
        prof.reset_serve_stats()
        prof.record_compile("decode.pstep", 0.25, "miss")
        prof.record_compile("decode.prefill", 0.5)
        for i in range(4):
            prof.record_step(i, collate_s=0.001 * i, dispatch_s=0.002,
                             compute_s=0.01, fetch_s=0.003, in_flight=2)
        prof.record_serve_batch(3, 4, 30, 40, queue_depth=5)
        prof.record_serve_batch(4, 4, 40, 40, queue_depth=2)
        prof.record_serve_requests([0.01, 0.02, 0.03, 0.5])
        prof.record_serve_request(0.04)
        prof.record_serve_error()
        st = prof.serve_stats()
        rate = st.pop("reqs_per_s")
        assert rate is None or rate > 0
        out.append((prof.compile_events(), prof.step_timeline(),
                    prof.step_timeline_summary(), st))
        prof.reset_serve_stats()
    assert out[1] == out[0]
    assert out[1][3]["requests"] == 5 and out[1][3]["errors"] == 1
    assert out[1][3]["queue_depth_max"] == 5


def test_trace_writes_a_chrome_trace(tmp_path):
    x = tpaddle.to_tensor(np.ones((8, 8), np.float32))
    tprof.start_trace(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="already running"):
        tprof.start_trace(str(tmp_path / "b"))
    with tprof.RecordEvent("traced.region"):
        tpaddle.matmul(x, x)
    path = tprof.stop_trace()
    assert tprof.stop_trace() is None
    with open(path) as f:
        doc = json.load(f)
    assert any(e.get("name") == "traced.region"
               for e in doc["traceEvents"])
    with tprof.trace(str(tmp_path / "c")):
        tpaddle.exp(x)
    assert len(list((tmp_path / "c").glob("trace_*.json"))) == 1


def test_utils_profiler_aliases_match_jax():
    assert tutils.Profiler() is tprof and jutils.Profiler() is jprof
    assert tutils.get_profiler() is tprof and jutils.get_profiler() is jprof
    assert tutils.ProfilerOptions({"a": 1}).options == \
        jutils.ProfilerOptions({"a": 1}).options == {"a": 1}
    assert tutils.ProfilerOptions().options == {}
    assert tpaddle.profiler is tprof
    assert tpaddle.monitor.stat_get("never_set", 7) == 7
