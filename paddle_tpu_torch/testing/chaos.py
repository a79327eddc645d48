"""Deterministic fault injection for the checkpoint/store/recovery stack.

Production code marks *named injection sites* with `maybe_fail(site)`;
with no schedule active that is a dict lookup and a return, so the hooks
stay in the hot path permanently. A schedule arms sites to raise a
chosen exception on chosen call numbers — deterministically, so every
recovery path is exercised by ordinary pytest instead of hope:

    from paddle_tpu_torch.testing import chaos
    with chaos.inject("ckpt.rename:1:OSError"):
        save_checkpoint(...)        # first rename raises OSError

or, process-wide, via the environment:

    PADDLE_TPU_CHAOS="store.req:1-3:ConnectionError;step.fn:5:RuntimeError"

Spec grammar (';'-separated rules):

    <site>:<calls>:<ExcName>

    site      dotted site name; '*' suffix wildcard matches a prefix
              ("ckpt.*"). Shipped sites: fs.put, ckpt.write,
              ckpt.rename, store.req, step.fn, and the serving path:
              serve.conn.read (before decoding a request),
              serve.conn.reply (before writing the reply),
              batcher.dispatch (dispatcher loop, per formed batch),
              batcher.worker (pool worker, per batch),
              router.forward (router, per backend attempt).
    calls     which hits fire, 1-based per site counter:
                "3"        call #3 only
                "1-4"      calls 1..4
                "2,5"      calls 2 and 5
                "3+"       call 3 and every later call
                "p0.3@7"   each call fails with prob 0.3, seeded RNG(7)
                           (seeded => the schedule is reproducible)
    ExcName   OSError | ConnectionError | ConnectionResetError |
              BrokenPipeError | TimeoutError | RuntimeError | IOError —
              the site raises; or the action form ``Hang@<seconds>``,
              which SLEEPS at the site instead of raising (wedged
              dispatcher, black-holed reply, slow-loris writer — the
              failure modes an exception cannot model).

Schedules record every fired fault in `.fired` for assertions. Counters
are per-schedule, so nesting `inject()` restarts the count.
"""
from __future__ import annotations

import random
import re
import threading
import time
from typing import Dict, List, Optional

from ..core import flags as _flags

__all__ = ["ChaosFault", "Rule", "Schedule", "inject", "maybe_fail",
           "active_schedule", "fail_once", "SITES", "register_site",
           "registered_sites", "sites_markdown"]

_EXC_REGISTRY = {
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "BrokenPipeError": BrokenPipeError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
}


class ChaosFault(RuntimeError):
    """Raised only when a rule names no concrete exception type."""


class Rule:
    """One armed site: which calls fire and what they raise."""

    def __init__(self, site: str, calls=None, from_call: int = None,
                 prob: float = None, seed: int = 0, exc=OSError,
                 hang_s: float = None):
        self.site = site
        self.calls = set(calls) if calls else None
        self.from_call = from_call
        self.prob = prob
        self.exc = exc
        self.hang_s = hang_s       # action rule: sleep instead of raise
        self._rng = random.Random(seed)

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site

    def should_fire(self, n: int) -> bool:
        if self.prob is not None:
            return self._rng.random() < self.prob
        if self.from_call is not None and n >= self.from_call:
            return True
        return self.calls is not None and n in self.calls

    def make_exc(self, site: str, n: int, detail=None) -> BaseException:
        msg = f"chaos[{site}#{n}]" + (f" {detail}" if detail else "")
        return self.exc(msg)

    @classmethod
    def parse(cls, text: str) -> "Rule":
        parts = text.strip().split(":")
        if len(parts) != 3:
            raise ValueError(
                f"chaos rule {text!r}: want <site>:<calls>:<ExcName>")
        site, calls_s, exc_s = parts
        exc, hang_s = _EXC_REGISTRY.get(exc_s), None
        if exc is None:
            hm = re.fullmatch(r"[Hh]ang@([0-9.]+)", exc_s)
            if hm is None:
                raise ValueError(
                    f"chaos rule {text!r}: unknown exception {exc_s!r} "
                    f"(one of {sorted(_EXC_REGISTRY)} or Hang@<seconds>)")
            hang_s = float(hm.group(1))
        m = re.fullmatch(r"p([0-9.]+)@(\d+)", calls_s)
        if m:
            return cls(site, prob=float(m.group(1)), seed=int(m.group(2)),
                       exc=exc, hang_s=hang_s)
        if calls_s.endswith("+"):
            return cls(site, from_call=int(calls_s[:-1]), exc=exc,
                       hang_s=hang_s)
        calls = set()
        for tok in calls_s.split(","):
            if "-" in tok:
                a, b = tok.split("-")
                calls.update(range(int(a), int(b) + 1))
            else:
                calls.add(int(tok))
        return cls(site, calls=calls, exc=exc, hang_s=hang_s)


class Schedule:
    """A set of rules plus per-site call counters (thread-safe)."""

    def __init__(self, rules: List[Rule]):
        self.rules = list(rules)
        self.counts = {}
        self.fired = []          # [(site, call_no, exc_type_name)]
        self._lock = threading.Lock()

    @classmethod
    def coerce(cls, spec) -> "Schedule":
        if isinstance(spec, Schedule):
            return spec
        if isinstance(spec, Rule):
            return cls([spec])
        if isinstance(spec, str):
            return cls([Rule.parse(r) for r in spec.split(";") if r.strip()])
        return cls(list(spec))    # iterable of Rules

    def hit(self, site: str, detail=None):
        hangs = []
        with self._lock:
            n = self.counts.get(site, 0) + 1
            self.counts[site] = n
            for r in self.rules:
                if r.matches(site) and r.should_fire(n):
                    if r.hang_s is not None:
                        # action rule: wedge the site (sleep OUTSIDE the
                        # lock so other sites keep counting meanwhile)
                        self.fired.append((site, n, f"Hang@{r.hang_s:g}"))
                        hangs.append(r.hang_s)
                        continue
                    self.fired.append((site, n, r.exc.__name__))
                    raise r.make_exc(site, n, detail)
        for s in hangs:
            time.sleep(s)


_STACK: List[Schedule] = []
_ENV_SPEC: Optional[str] = None
_ENV_SCHED: Optional[Schedule] = None


def active_schedule() -> Optional[Schedule]:
    """The innermost `inject()` schedule, else the PADDLE_TPU_CHAOS env
    schedule (parsed once per distinct value), else None."""
    global _ENV_SPEC, _ENV_SCHED
    if _STACK:
        return _STACK[-1]
    spec = _flags.env_raw("PADDLE_TPU_CHAOS")
    if not spec:
        _ENV_SPEC = _ENV_SCHED = None
        return None
    if spec != _ENV_SPEC:
        _ENV_SPEC, _ENV_SCHED = spec, Schedule.coerce(spec)
    return _ENV_SCHED


# ---------------------------------------------------------------------------
# Site registry.  Every maybe_fail()/fail_once() site name must be declared
# here (name -> where it is compiled into the production path). The table
# is the JAX package's, so a schedule written for one package arms the
# same sites in the other.
# ---------------------------------------------------------------------------
SITES: Dict[str, str] = {}


def register_site(name: str, doc: str) -> None:
    """Declare one chaos injection site (idempotent; last doc wins)."""
    SITES[name] = doc


def registered_sites() -> Dict[str, str]:
    """name -> doc for every registered site, sorted by name."""
    return dict(sorted(SITES.items()))


def sites_markdown() -> str:
    """The docs/fault_tolerance.md site table, generated from the registry."""
    width = max(len(n) for n in SITES) + 2 if SITES else 10
    lines = [f"| {'site'.ljust(width)} | where |",
             f"|{'-' * (width + 2)}|-------|"]
    for name, doc in sorted(SITES.items()):
        lines.append(f"| {('`' + name + '`').ljust(width)} | {doc} |")
    return "\n".join(lines)


register_site("ckpt.write", "each shard write in `save_sharded`")
register_site("ckpt.rename", "the atomic commit rename")
register_site("fs.put", "`LocalFS.put/put_file`, `RemoteFS.put/put_file`")
register_site("store.req", "every `TCPStore` request, `FileStore` mutators")
register_site("step.fn", "each step of `run_with_recovery`")
register_site("serve.conn.read", "each request decode in a serve conn thread")
register_site("serve.conn.reply", "each reply send in a serve conn thread")
register_site("batcher.dispatch", "each batch the dispatcher forms")
register_site("batcher.worker", "each batch a pool worker executes")
register_site("router.forward", "each router->backend forward attempt")
register_site("router.stream_relay",
              "each stream relay attempt against one backend")
register_site("serve.stream_write",
              "each stream frame write (token or done) in decode serving")
register_site("decode.stream", "each token delivery in the decode engine")
register_site("decode.page_alloc",
              "each KV page allocation in the paged decode engine")
register_site("decode.preempt",
              "each preempt-to-host eviction in the decode engine "
              "(a raise abandons the preemption: the victim keeps "
              "decoding and the candidate is requeued)")
register_site("batcher.quota",
              "each per-tenant quota check during anchor selection "
              "(a raise defers the tenant as if quota-blocked; "
              "requests queue, never drop)")
register_site("page.migrate",
              "each host<->device page-migration batch in the KV-tier "
              "migration worker (memory/migration.py); a raise fails "
              "that batch — spill failures drop the affected cache "
              "entries, refetch failures degrade the waiting stream to "
              "a re-prefill — and a hang stalls only streams parked on "
              "those pages")
register_site("handoff.send",
              "each prefill->decode KV handoff the router orchestrates "
              "for a routed stream (inference/router.py); a raise cuts "
              "the handoff before any page ships and the stream "
              "degrades to a plain re-prefill on its decode worker, "
              "token-identically")


def maybe_fail(site: str, detail=None):
    """Injection-site hook: no-op unless a schedule arms `site`."""
    sched = active_schedule()
    if sched is not None:
        # Validated only when armed, so the idle production path stays a
        # dict lookup + None check.  An unregistered site is a programming
        # error: the registry (and docs/fault_tolerance.md generated from
        # it) must name every site compiled into the code.
        if site not in SITES:
            raise ValueError(
                f"chaos site {site!r} is not registered — add a "
                "register_site() entry in testing/chaos.py")
        sched.hit(site, detail)


class inject:
    """Context manager arming a schedule for the enclosed block.

    `spec` is a grammar string (module docstring), a Rule, an iterable
    of Rules, or a prebuilt Schedule. Yields the Schedule so tests can
    assert on `.fired` / `.counts`.
    """

    def __init__(self, spec):
        self.schedule = Schedule.coerce(spec)

    def __enter__(self) -> Schedule:
        _STACK.append(self.schedule)
        return self.schedule

    def __exit__(self, *exc):
        _STACK.pop()
        return False


def fail_once(site: str, call: int = 1, exc=OSError) -> inject:
    """Shorthand: `with chaos.fail_once("ckpt.rename"): ...`."""
    return inject(Rule(site, calls={call}, exc=exc))
