"""paddle_tpu_torch's `ops/stat.py` against the JAX package's, name by
name (harness: tests/torch_op_parity.py): values, dtypes and shapes,
gradients, and the AMP dispatch names; `median` averages the middle
pair of an even count."""
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as tp                                    # noqa: E402
from paddle_tpu.ops import stat as jmod  # noqa: E402

from torch_op_cases import STAT_CASES as CASES  # noqa: E402
from torch_op_parity import assert_covered, check_case, cpu_default  # noqa


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_stat_matches_jax(case):
    check_case(case)


def test_every_stat_name_has_a_case():
    assert_covered(jmod.__all__, CASES)
    for n in jmod.__all__:
        assert callable(getattr(tp, n)), n
