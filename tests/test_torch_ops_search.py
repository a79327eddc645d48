"""paddle_tpu_torch's `ops/search.py` against the JAX package's, name by
name (harness: tests/torch_op_parity.py): values, dtypes and shapes,
gradients, and the AMP dispatch names. Ties go as in the JAX package:
stable sorts, `topk` and `kthvalue` to the lowest index, `mode` the
smallest most frequent value and its count."""
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as tp                                    # noqa: E402
from paddle_tpu.ops import search as jmod  # noqa: E402

from torch_op_cases import SEARCH_CASES as CASES  # noqa: E402
from torch_op_parity import assert_covered, check_case, cpu_default  # noqa


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_search_matches_jax(case):
    check_case(case)


def test_every_search_name_has_a_case():
    assert_covered(jmod.__all__, CASES)
    for n in jmod.__all__:
        assert callable(getattr(tp, n)), n
