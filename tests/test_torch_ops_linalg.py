"""paddle_tpu_torch's `ops/linalg.py` against the JAX package's, name by
name (harness: tests/torch_op_parity.py): values, dtypes and shapes,
gradients, and the AMP dispatch names. Eigenvectors and singular vectors
are held by invariants (A v = w v, reconstructions), which no phase or
sign changes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp                                          # noqa: E402
import paddle_tpu_torch as tp                                    # noqa: E402
from paddle_tpu.ops import linalg as jmod  # noqa: E402

from torch_op_cases import LINALG_CASES as CASES  # noqa: E402
from torch_op_parity import assert_covered, check_case, cpu_default  # noqa


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_default(monkeypatch)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_linalg_matches_jax(case):
    check_case(case)


def test_every_linalg_name_has_a_case():
    assert_covered(jmod.__all__, CASES)
    for n in jmod.__all__:
        assert callable(getattr(tp, n)), n


def test_norm_fro_with_an_int_axis_is_the_2_norm():
    """paddle's default p="fro" with one int axis: the JAX package raises
    (its general branch takes |x| ** "fro"); the port gives the vector
    2-norm over that axis, paddle's meaning (ROADMAP queue 3)."""
    import numpy as np
    import paddle_tpu as jp
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    with pytest.raises(TypeError):
        jp.norm(jp.to_tensor(x), axis=1)
    got = tp.norm(tp.to_tensor(x), axis=1, keepdim=True)
    np.testing.assert_allclose(got.numpy(), np.linalg.norm(x, axis=1,
                                                           keepdims=True),
                               rtol=1e-6)
