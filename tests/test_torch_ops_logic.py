"""paddle_tpu_torch's `ops/logic.py` against the JAX package's, name by
name (harness: tests/torch_op_parity.py): values, dtypes and shapes, and
the AMP dispatch names. The `Tensor` comparison and bitwise dunders are
cases too."""
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as tp                                    # noqa: E402
from paddle_tpu.ops import logic as jmod  # noqa: E402

from torch_op_cases import LOGIC_CASES as CASES  # noqa: E402
from torch_op_parity import assert_covered, check_case, cpu_default  # noqa


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_logic_matches_jax(case):
    check_case(case)


def test_every_logic_name_has_a_case():
    assert_covered(jmod.__all__, CASES)
    for n in jmod.__all__:
        assert callable(getattr(tp, n)), n
