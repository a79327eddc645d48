"""paddle_tpu_torch's PageAllocator against the JAX package's.

The same seeded sequence of alloc / retain / release (with owner tags)
goes through both allocators; every grant, refcount and stats snapshot
must be identical, and page 0 (the null page the decode step writes
padding into) must never be handed out.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from paddle_tpu.memory import page_allocator as jpa  # noqa: E402
from paddle_tpu_torch.memory import page_allocator as tpa  # noqa: E402


@pytest.mark.parametrize("num_pages", [2, 9, 33])
def test_allocator_matches_jax(num_pages):
    rng = np.random.default_rng(num_pages)
    j, t = jpa.PageAllocator(num_pages), tpa.PageAllocator(num_pages)
    held = []                                   # one entry per reference
    for step in range(200):
        owner = ("slot", int(rng.integers(4)), "default") \
            if rng.random() < 0.7 else ("trie", f"n{step % 3}")
        op = rng.random()
        if op < 0.45:
            n = int(rng.integers(1, 4))
            errs = []
            for a in (j, t):
                try:
                    errs.append(a.alloc(n, owner=owner))
                except (jpa.PageExhausted, tpa.PageExhausted) as e:
                    errs.append((type(e).__name__, e.requested, e.free))
            assert errs[0] == errs[1]
            if isinstance(errs[1], list):
                assert tpa.NULL_PAGE not in errs[1]
                held += [(p, owner) for p in errs[1]]
        elif op < 0.65 and held:
            p, _ = held[int(rng.integers(len(held)))]
            assert j.retain(p, owner=owner) == t.retain(p, owner=owner)
            held.append((p, owner))
        elif held:
            p, own = held.pop(int(rng.integers(len(held))))
            assert j.release(p, owner=own) == t.release(p, owner=own)
        assert j.stats() == t.stats()
    assert t.stats()["pages_total"] == num_pages - 1
    with pytest.raises(ValueError):
        tpa.PageAllocator(1)
    with pytest.raises(ValueError):
        t.release(tpa.NULL_PAGE)
