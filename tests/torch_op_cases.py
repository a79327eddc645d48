"""The op library's cases: one call of the paddle API each, a function of
the package (`P`, either `paddle_tpu` or `paddle_tpu_torch`) and of
tensors made from seeded numpy inputs. Plain numpy: the parity tests
(tests/test_torch_ops_*.py, through tests/torch_op_parity.py) run them
against the JAX package on the CPU, and chip_smoke.py's phase 13 runs
them on the card against the port on the CPU.

Every name of the `__all__` of the JAX package's `ops/creation.py`,
`ops/math.py`, `ops/manipulation.py`, `ops/linalg.py`, `ops/logic.py`,
`ops/search.py` and `ops/stat.py`, and `einsum`, has at least one case
(`ops/random.py` draws numbers the packages cannot share:
tests/test_torch_ops_random.py holds it to its laws). A case that
pins a behaviour where torch's own function differs from the JAX
package's carries an `id` naming it (`topk_ties_lowest_index`, ...)."""
import numpy as np

FP32 = dict(rtol=1e-5, atol=1e-6)
TRANS = dict(rtol=1e-4, atol=1e-4)     # tests/test_ops.py:27-34


class Case:
    """`fn(P, *tensors)`; `inputs` numpy arrays (made tensors of their
    own dtype) or other values passed as they are."""

    def __init__(self, name, fn, inputs=(), grad=False, tol=FP32, tag="",
                 id=None):
        self.name, self.fn, self.inputs = name, fn, list(inputs)
        self.grad, self.tol = grad, tol
        self.id = id or (f"{name}-{tag}" if tag else name)


class Rand:
    """Seeded inputs: normal floats, uniform floats in a range, ints."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def f(self, *shape, dtype="float32"):
        return self.rng.standard_normal(shape).astype(dtype)

    def u(self, lo, hi, *shape, dtype="float32"):
        return self.rng.uniform(lo, hi, shape).astype(dtype)

    def i(self, lo, hi, *shape, dtype="int64"):
        return self.rng.integers(lo, hi, shape).astype(dtype)


# -- ops/math.py --------------------------------------------------------------

R = Rand(11)
f34, g34 = R.f(3, 4), R.f(3, 4)
i34, j34 = R.i(-5, 6, 3, 4), R.i(1, 6, 3, 4)
i32 = R.i(-5, 6, 5, dtype="int32")
pos = R.u(0.5, 3.0, 3, 4)
unit = R.u(-0.9, 0.9, 3, 4)
big = R.u(1.1, 4.0, 3, 4)
bools = R.i(0, 2, 3, 4).astype(bool)
f64 = R.f(3, 4, dtype="float64")
nan_in = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
cplx = (R.f(4) + 1j * R.f(4)).astype(np.complex64)

MATH_CASES = [
    Case("add", lambda P, x, y: P.add(x, y), [f34, g34], grad=True),
    Case("add", lambda P, x, y: P.add(x, y), [R.f(3, 1, 4), R.f(2, 4)],
         grad=True, tag="broadcast"),
    Case("add", lambda P, x, y: P.add(x, y), [i34, j34], tag="int"),
    Case("add", lambda P, x: P.add(x, 2.5), [i34], tag="int+float"),
    Case("add", lambda P, x, y: P.add(x, y), [f34, f64], tag="f32+f64"),
    Case("subtract", lambda P, x, y: P.subtract(x, y), [f34, g34], grad=True),
    Case("multiply", lambda P, x, y: P.multiply(x, y), [R.f(3, 1), R.f(1, 4)],
         grad=True),
    Case("multiply", lambda P, x, y: P.multiply(x, y), [bools, i34],
         tag="bool*int"),
    Case("divide", lambda P, x, y: P.divide(x, y), [f34, pos], grad=True),
    Case("divide", lambda P, x, y: P.divide(x, y), [i34, j34], tag="int"),
    Case("floor_divide", lambda P, x, y: P.floor_divide(x, y), [i34, j34]),
    Case("floor_divide", lambda P, x, y: P.floor_divide(x, y), [f34, pos],
         tag="float"),
    Case("remainder", lambda P, x, y: P.remainder(x, y), [i34, j34]),
    Case("remainder", lambda P, x, y: P.remainder(x, y), [f34, pos],
         tag="float"),
    Case("mod", lambda P, x: P.mod(x, 3), [i34]),
    Case("floor_mod", lambda P, x, y: P.floor_mod(x, y), [i34, j34]),
    Case("pow", lambda P, x: P.pow(x, 3), [f34], grad=True),
    Case("pow", lambda P, x, y: P.pow(x, y), [pos, f34], grad=True,
         tol=TRANS, tag="tensor"),
    Case("pow", lambda P, x: P.pow(x, 2), [i34], tag="int"),
    Case("sqrt", lambda P, x: P.sqrt(x), [pos], grad=True, tol=TRANS),
    Case("sqrt", lambda P, x: P.sqrt(x), [j34], tol=TRANS, tag="int64"),
    Case("sqrt", lambda P, x: P.sqrt(x), [np.abs(i32)], tol=TRANS,
         tag="int32"),
    Case("rsqrt", lambda P, x: P.rsqrt(x), [pos], grad=True, tol=TRANS),
    Case("square", lambda P, x: P.square(x), [f34], grad=True),
    Case("square", lambda P, x: P.square(x), [i34], tag="int"),
    Case("exp", lambda P, x: P.exp(x), [f34], grad=True, tol=TRANS),
    Case("expm1", lambda P, x: P.expm1(x), [f34], grad=True, tol=TRANS),
    Case("log", lambda P, x: P.log(x), [pos], grad=True, tol=TRANS),
    Case("log2", lambda P, x: P.log2(x), [pos], grad=True, tol=TRANS),
    Case("log10", lambda P, x: P.log10(x), [pos], grad=True, tol=TRANS),
    Case("log1p", lambda P, x: P.log1p(x), [pos], grad=True, tol=TRANS),
    Case("abs", lambda P, x: P.abs(x), [f34], grad=True),
    Case("abs", lambda P, x: P.abs(x), [i34], tag="int"),
    Case("neg", lambda P, x: P.neg(x), [f34], grad=True),
    Case("sign", lambda P, x: P.sign(x), [f34]),
    Case("floor", lambda P, x: P.floor(x), [f34 * 3]),
    Case("floor", lambda P, x: P.floor(x), [i34], tag="int"),
    Case("ceil", lambda P, x: P.ceil(x), [f34 * 3]),
    Case("round", lambda P, x: P.round(x), [f34 * 3]),
    Case("trunc", lambda P, x: P.trunc(x), [f34 * 3]),
    Case("sin", lambda P, x: P.sin(x), [f34], grad=True, tol=TRANS),
    Case("sin", lambda P, x: P.sin(x), [i34], tol=TRANS, tag="int64"),
    Case("cos", lambda P, x: P.cos(x), [f34], grad=True, tol=TRANS),
    Case("tan", lambda P, x: P.tan(x), [unit], grad=True, tol=TRANS),
    Case("asin", lambda P, x: P.asin(x), [unit], grad=True, tol=TRANS),
    Case("acos", lambda P, x: P.acos(x), [unit], grad=True, tol=TRANS),
    Case("atan", lambda P, x: P.atan(x), [f34], grad=True, tol=TRANS),
    Case("sinh", lambda P, x: P.sinh(x), [f34], grad=True, tol=TRANS),
    Case("cosh", lambda P, x: P.cosh(x), [f34], grad=True, tol=TRANS),
    Case("tanh", lambda P, x: P.tanh(x), [f34], grad=True, tol=TRANS),
    Case("tanh", lambda P, x: P.tanh(x), [i32], tol=TRANS, tag="int32"),
    Case("tanh_", lambda P, x: (P.tanh_(x), x), [f34], tol=TRANS),
    Case("asinh", lambda P, x: P.asinh(x), [f34], grad=True, tol=TRANS),
    Case("acosh", lambda P, x: P.acosh(x), [big], grad=True, tol=TRANS),
    Case("atanh", lambda P, x: P.atanh(x), [unit], grad=True, tol=TRANS),
    Case("reciprocal", lambda P, x: P.reciprocal(x), [pos], grad=True),
    Case("reciprocal", lambda P, x: P.reciprocal(x), [j34], tag="int"),
    Case("addmm", lambda P, i, x, y: P.addmm(i, x, y, beta=0.5, alpha=2.0),
         [R.f(3, 5), R.f(3, 4), R.f(4, 5)], grad=True),
    Case("all", lambda P, x: P.all(x, axis=1), [bools]),
    Case("all", lambda P, x: P.all(x), [bools], tag="full"),
    Case("any", lambda P, x: P.any(x, axis=[0, 1], keepdim=True), [bools]),
    Case("clip", lambda P, x: P.clip(x, -0.5, 0.5), [f34], grad=True),
    Case("clip", lambda P, x: P.clip(x, min=0.0), [f34], tag="min"),
    Case("clip", lambda P, x: P.clip(x, 1, 3), [i34], tag="int"),
    Case("maximum", lambda P, x, y: P.maximum(x, y), [f34, g34], grad=True),
    Case("maximum", lambda P, x, y: P.maximum(x, y), [i34, f34],
         tag="int,float"),
    Case("minimum", lambda P, x, y: P.minimum(x, y), [f34, g34], grad=True),
    Case("fmax", lambda P, x, y: P.fmax(x, y), [nan_in, nan_in[::-1].copy()]),
    Case("fmin", lambda P, x, y: P.fmin(x, y), [nan_in, nan_in[::-1].copy()]),
    Case("max", lambda P, x: P.max(x, axis=1), [f34], grad=True),
    Case("max", lambda P, x: P.max(x), [f34], grad=True, tag="full"),
    Case("max", lambda P, x: P.max(x, axis=[0, 1], keepdim=True), [i34],
         tag="int"),
    Case("min", lambda P, x: P.min(x, axis=-1, keepdim=True), [f34],
         grad=True),
    Case("amax", lambda P, x: P.amax(x, axis=0), [f34], grad=True),
    Case("amin", lambda P, x: P.amin(x, axis=0), [f34], grad=True),
    Case("sum", lambda P, x: P.sum(x, axis=1), [f34], grad=True),
    Case("sum", lambda P, x: P.sum(x), [f34], grad=True, tag="full"),
    Case("sum", lambda P, x: P.sum(x, axis=[0, 1], keepdim=True), [f34],
         grad=True, tag="keepdim"),
    Case("sum", lambda P, x: P.sum(x, axis=0), [i32], tag="int32"),
    Case("sum", lambda P, x: P.sum(x), [bools], tag="bool"),
    Case("sum", lambda P, x: P.sum(x, dtype="float64"), [f34], tag="dtype"),
    Case("nansum", lambda P, x: P.nansum(x), [nan_in[:2]]),
    Case("nansum", lambda P, x: P.nansum(x, axis=1), [i34], tag="int"),
    Case("mean", lambda P, x: P.mean(x, axis=0), [f34], grad=True),
    Case("mean", lambda P, x: P.mean(x), [i34], tag="int64"),
    Case("mean", lambda P, x: P.mean(x, axis=1, keepdim=True), [i32.reshape(1, 5)],
         tag="int32"),
    Case("nanmean", lambda P, x: P.nanmean(x), [nan_in[:2]]),
    Case("prod", lambda P, x: P.prod(x, axis=1), [f34], grad=True),
    Case("prod", lambda P, x: P.prod(x, axis=[0, 1]), [i34], tag="int"),
    Case("prod", lambda P, x: P.prod(x), [R.u(0.5, 1.5, 2, 3)],
         tag="full"),
    Case("cumsum", lambda P, x: P.cumsum(x, axis=1), [f34], grad=True),
    Case("cumsum", lambda P, x: P.cumsum(x), [i32], tag="int32,flat"),
    Case("cumsum", lambda P, x: P.cumsum(x, axis=0), [bools], tag="bool"),
    Case("cumprod", lambda P, x: P.cumprod(x, dim=1), [f34], grad=True),
    Case("cumprod", lambda P, x: P.cumprod(x, dim=0), [i34], tag="int"),
    Case("logsumexp", lambda P, x: P.logsumexp(x), [f34], grad=True,
         tol=TRANS),
    Case("logsumexp", lambda P, x: P.logsumexp(x, axis=1, keepdim=True),
         [f34], grad=True, tol=TRANS, tag="axis"),
    Case("logcumsumexp", lambda P, x: P.logcumsumexp(x, axis=1), [f34],
         grad=True, tol=TRANS),
    Case("logcumsumexp", lambda P, x: P.logcumsumexp(x), [f34], tol=TRANS,
         tag="flat"),
    Case("add_n", lambda P, x, y, z: P.add_n([x, y, z]), [f34, g34, f34 * 2],
         grad=True),
    Case("add_n", lambda P, x: P.add_n(x), [f34], tag="single"),
    Case("scale", lambda P, x: P.scale(x, 2.0, 1.0), [f34], grad=True),
    Case("scale", lambda P, x: P.scale(x, 2.0, 1.0, bias_after_scale=False),
         [f34], tag="bias_first"),
    Case("scale", lambda P, x: P.scale(x, 3.0), [i34], tag="int"),
    Case("scale", lambda P, x: P.scale(x, 0.5, act="relu"), [f34],
         grad=True, tag="act"),
    Case("stanh", lambda P, x: P.stanh(x), [f34], grad=True, tol=TRANS),
    Case("erf", lambda P, x: P.erf(x), [f34], grad=True, tol=TRANS),
    Case("erfinv", lambda P, x: P.erfinv(x), [unit], grad=True, tol=TRANS),
    Case("lgamma", lambda P, x: P.lgamma(x), [pos], grad=True, tol=TRANS),
    Case("digamma", lambda P, x: P.digamma(x), [pos], grad=True, tol=TRANS),
    Case("atan2", lambda P, x, y: P.atan2(x, y), [f34, g34], grad=True,
         tol=TRANS),
    Case("atan2", lambda P, x, y: P.atan2(x, y), [i32, i32[::-1].copy()],
         tol=TRANS, tag="int32"),
    Case("isnan", lambda P, x: P.isnan(x), [nan_in]),
    Case("isinf", lambda P, x: P.isinf(x), [nan_in]),
    Case("isfinite", lambda P, x: P.isfinite(x), [nan_in]),
    Case("nan_to_num", lambda P, x: P.nan_to_num(x), [nan_in]),
    Case("nan_to_num", lambda P, x: P.nan_to_num(x, 1.0, 9.0, -9.0),
         [nan_in], tag="values"),
    Case("kron", lambda P, x, y: P.kron(x, y), [R.f(2, 3), R.f(2, 2)],
         grad=True),
    Case("kron", lambda P, x, y: P.kron(x, y), [R.i(0, 4, 2, 2),
                                                 R.i(0, 4, 2, 2)],
         tag="int"),
    Case("inner", lambda P, x, y: P.inner(x, y), [R.f(3, 4), R.f(5, 4)],
         grad=True),
    Case("outer", lambda P, x, y: P.outer(x, y), [R.f(3), R.f(4)],
         grad=True),
    Case("trace", lambda P, x: P.trace(x), [R.f(4, 4)], grad=True),
    Case("trace", lambda P, x: P.trace(x, offset=1, axis1=1, axis2=2),
         [R.f(2, 3, 4)], grad=True, tag="offset"),
    Case("increment", lambda P, x: (P.increment(x, 2.0), x),
         [np.array([1.0], np.float32)]),
    Case("multiplex", lambda P, a, b, i: P.multiplex([a, b], i),
         [R.f(4, 3), R.f(4, 3), np.array([[0], [1], [1], [0]], np.int32)],
         grad=True),
    Case("lerp", lambda P, x, y: P.lerp(x, y, 0.3), [f34, g34], grad=True),
    Case("lerp", lambda P, x, y, w: P.lerp(x, y, w), [f34, g34,
                                                      R.u(0, 1, 3, 4)],
         grad=True, tag="tensor"),
    Case("rad2deg", lambda P, x: P.rad2deg(x), [f34], grad=True),
    Case("deg2rad", lambda P, x: P.deg2rad(x), [f34 * 90], grad=True),
    Case("gcd", lambda P, x, y: P.gcd(x, y), [R.i(0, 40, 6), R.i(0, 40, 6)]),
    Case("gcd", lambda P, x, y: P.gcd(x, y), [R.i(0, 40, 6, dtype="int32"),
                                               R.i(0, 40, 6)], tag="mixed"),
    Case("lcm", lambda P, x, y: P.lcm(x, y), [R.i(1, 12, 6), R.i(1, 12, 6)]),
    Case("angle", lambda P, x: P.angle(x), [cplx], tol=TRANS),
    Case("angle", lambda P, x: P.angle(x), [f34], tol=TRANS, tag="real"),
    Case("conj", lambda P, x: P.conj(x), [cplx]),
    Case("conj", lambda P, x: P.conj(x), [f34], tag="real"),
    Case("real", lambda P, x: P.real(x), [cplx]),
    Case("imag", lambda P, x: P.imag(x), [cplx]),
    Case("imag", lambda P, x: P.imag(x), [f34], tag="real"),
    Case("heaviside", lambda P, x, y: P.heaviside(x, y),
         [np.array([-1.0, 0.0, 2.0], np.float32),
          np.array([0.5, 0.5, 0.5], np.float32)]),
    Case("frac", lambda P, x: P.frac(x), [f34 * 3], grad=True),
    Case("frac", lambda P, x: P.frac(x), [i34], tag="int"),
    Case("sgn", lambda P, x: P.sgn(x), [f34]),
    Case("sgn", lambda P, x: P.sgn(x), [cplx], tag="complex"),
    Case("diff", lambda P, x: P.diff(x), [f34], grad=True),
    Case("diff", lambda P, x, p, a: P.diff(x, n=2, axis=0, prepend=p,
                                            append=a),
         [f34, R.f(1, 4), R.f(2, 4)], grad=True, tag="pre_append"),
    Case("diff", lambda P, x: P.diff(x), [i34], tag="int"),
    Case("count_nonzero", lambda P, x: P.count_nonzero(x, axis=1),
         [i34]),
    Case("count_nonzero", lambda P, x: P.count_nonzero(x, keepdim=True),
         [f34 * (i34 > 0)], tag="keepdim"),
]


# -- ops/manipulation.py ------------------------------------------------------

R = Rand(23)
x234 = R.f(2, 3, 4)
f34 = R.f(3, 4)
i34 = R.i(0, 9, 3, 4)
idx3 = np.array([0, 2, 1], np.int64)
cplx = (R.f(3) + 1j * R.f(3)).astype(np.complex64)

MANIPULATION_CASES = [
    Case("reshape", lambda P, x: P.reshape(x, [6, 4]), [x234], grad=True),
    Case("reshape", lambda P, x: P.reshape(x, [-1, 2]), [x234], grad=True,
         tag="minus1"),
    Case("reshape", lambda P, x: x.reshape([4, -1]), [i34], tag="method"),
    Case("reshape_", lambda P, x: (P.reshape_(x, [4, 6]), x), [x234]),
    Case("view", lambda P, x: P.view(x, [3, 8]), [x234], grad=True),
    Case("view_as", lambda P, x, y: P.view_as(x, y), [x234, R.f(6, 4)],
         grad=True),
    Case("flatten", lambda P, x: P.flatten(x, 1, 2), [x234], grad=True),
    Case("flatten", lambda P, x: P.flatten(x), [x234], tag="all"),
    Case("squeeze", lambda P, x: P.squeeze(x, 1), [R.f(3, 1, 4)],
         grad=True),
    Case("squeeze", lambda P, x: P.squeeze(x), [R.f(1, 3, 1)], tag="all"),
    Case("squeeze", lambda P, x: P.squeeze(x, [0, 1]), [R.f(1, 3, 1)],
         tag="list_not_one"),
    Case("squeeze_", lambda P, x: (P.squeeze_(x, 0), x), [R.f(1, 3)]),
    Case("unsqueeze", lambda P, x: P.unsqueeze(x, 0), [f34], grad=True),
    Case("unsqueeze", lambda P, x: P.unsqueeze(x, [0, -1]), [f34],
         tag="list"),
    Case("unsqueeze_", lambda P, x: (P.unsqueeze_(x, 1), x), [f34]),
    Case("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), [x234],
         grad=True),
    Case("transpose", lambda P, x: x.transpose([1, 0]), [f34],
         tag="method"),
    Case("concat", lambda P, x, y: P.concat([x, y], axis=0), [f34, f34 * 2],
         grad=True),
    Case("concat", lambda P, x, y: P.concat([x, y], axis=1), [f34, i34],
         tag="mixed"),
    Case("stack", lambda P, x, y: P.stack([x, y], axis=1), [f34, f34 + 1],
         grad=True),
    Case("split", lambda P, x: P.split(x, 3, axis=0), [R.f(6, 2)],
         grad=True),
    Case("split", lambda P, x: P.split(x, [1, -1, 1], axis=1), [R.f(2, 5)],
         grad=True, tag="sections"),
    Case("split", lambda P, x: P.split(x, 3), [R.f(7)], tag="remainder"),
    Case("chunk", lambda P, x: P.chunk(x, 2, axis=1), [f34], grad=True),
    Case("tile", lambda P, x: P.tile(x, [2, 1, 1]), [x234], grad=True),
    Case("tile", lambda P, x: P.tile(x, [2]), [f34], tag="short"),
    Case("expand", lambda P, x: P.expand(x, [2, 3, 4]), [R.f(3, 1)],
         grad=True),
    Case("expand", lambda P, x: P.expand(x, [2, -1, 4]), [R.f(3, 1)],
         tag="minus1"),
    Case("expand_as", lambda P, x, y: P.expand_as(x, y), [R.f(1, 4), f34],
         grad=True),
    Case("broadcast_to", lambda P, x: P.broadcast_to(x, [2, 3, 4]),
         [R.f(1, 4)], grad=True),
    Case("broadcast_shape", lambda P: P.broadcast_shape([2, 1, 4], [3, 1])),
    Case("flip", lambda P, x: P.flip(x, axis=[0]), [x234], grad=True),
    Case("flip", lambda P, x: P.flip(x, 2), [x234], tag="int"),
    Case("reverse", lambda P, x: P.reverse(x, [0, 1]), [x234], grad=True),
    Case("roll", lambda P, x: P.roll(x, 1, axis=0), [x234], grad=True),
    Case("roll", lambda P, x: P.roll(x, 5), [x234], tag="flat"),
    Case("gather", lambda P, x, i: P.gather(x, i, axis=0), [R.f(5, 3),
                                                             idx3],
         grad=True),
    Case("gather", lambda P, x, i: P.gather(x, i, axis=1),
         [x234, np.array([[0], [2]], np.int64)], grad=True, tag="2d_index"),
    Case("gather", lambda P, x, i: P.gather(x, i), [R.f(5, 3),
                                                    idx3.astype(np.int32)],
         tag="int32_index"),
    Case("gather_nd", lambda P, x, i: P.gather_nd(x, i),
         [x234, np.array([[0, 1], [1, 2]], np.int64)], grad=True),
    Case("gather_nd", lambda P, x, i: P.gather_nd(x, i),
         [x234, np.array([[1, 2, 3], [0, 0, 0]], np.int64)], tag="full"),
    Case("scatter", lambda P, x, i, u: P.scatter(x, i, u),
         [R.f(4, 3), np.array([2, 0], np.int64), R.f(2, 3)], grad=True),
    Case("scatter", lambda P, x, i, u: P.scatter(x, i, u, overwrite=False),
         [R.f(4, 3), np.array([2, 0, 2], np.int64), R.f(3, 3)], grad=True,
         tag="accumulate"),
    Case("scatter_", lambda P, x, i, u: (P.scatter_(x, i, u), x),
         [R.f(4, 3), np.array([1], np.int64), R.f(1, 3)]),
    Case("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [3, 4]),
         [np.array([[1], [2], [1]], np.int64), R.f(3, 4)], grad=True),
    Case("scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u),
         [f34, np.array([[0, 1], [2, 3], [0, 1]], np.int64), R.f(3)],
         grad=True),
    Case("index_select", lambda P, x, i: P.index_select(x, i, axis=2),
         [x234, np.array([3, 0], np.int64)], grad=True),
    Case("index_add", lambda P, x, i, v: P.index_add(x, i, 1, v),
         [f34, np.array([0, 3, 0], np.int64), R.f(3, 3)], grad=True),
    Case("slice", lambda P, x: P.slice(x, [1, 2], [0, 1], [2, 3]), [x234],
         grad=True),
    Case("slice", lambda P, x: P.slice(x, [0], [-1], [10000]), [x234],
         tag="clamped"),
    Case("strided_slice", lambda P, x: P.strided_slice(
        x, [2], [0], [4], [2]), [x234], grad=True),
    Case("strided_slice", lambda P, x: P.strided_slice(
        x, [1, 2], [2, 3], [-4, 0], [-1, -2]), [x234], grad=True,
         tag="negative"),
    Case("unique", lambda P, x: P.unique(x), [R.i(0, 4, 8)]),
    Case("unique", lambda P, x: P.unique(x, return_index=True,
                                         return_inverse=True,
                                         return_counts=True),
         [R.i(0, 4, 8)], tag="flags"),
    Case("unique", lambda P, x: P.unique(x), [R.i(0, 3, 6).astype(
        np.float64)], tag="float64"),
    Case("unique_consecutive", lambda P, x: P.unique_consecutive(
        x, return_inverse=True, return_counts=True),
         [np.array([1, 1, 2, 2, 3, 1], np.int64)]),
    Case("unique_consecutive", lambda P, x: P.unique_consecutive(x),
         [np.array([[1, 1], [1, 1], [2, 2]], np.int64)], tag="2d_flat"),
    Case("unbind", lambda P, x: P.unbind(x, axis=1), [x234], grad=True),
    Case("unstack", lambda P, x: P.unstack(x), [f34], grad=True),
    Case("cast", lambda P, x: P.cast(x, "int32"), [f34 * 3]),
    Case("cast", lambda P, x: P.cast(x, "float64"), [f34], grad=True,
         tag="float64"),
    Case("cast", lambda P, x: P.cast(x, "bfloat16"), [f34], tag="bf16",
         tol=dict(rtol=0, atol=0)),
    Case("cast", lambda P, x: x.astype("bool"), [i34], tag="bool"),
    Case("pad", lambda P, x: P.pad(x, [1, 2]), [R.f(2, 3, 4)], grad=True),
    Case("pad", lambda P, x: P.pad(x, [1, 2, 0, 1], value=2.0),
         [R.f(2, 3, 4, 5)], grad=True, tag="nchw_value"),
    Case("pad", lambda P, x: P.pad(x, [1, 1, 2, 0, 0, 1]), [x234],
         grad=True, tag="every_dim"),
    Case("pad", lambda P, x: P.pad(x, [1, 2], mode="reflect"),
         [R.f(2, 3, 4)], grad=True, tag="reflect"),
    Case("pad", lambda P, x: P.pad(x, [2, 1, 1, 3], mode="replicate"),
         [R.f(1, 2, 3, 4)], grad=True, tag="replicate"),
    Case("pad", lambda P, x: P.pad(x, [1, 3], mode="circular"),
         [R.f(2, 3, 4)], grad=True, tag="circular"),
    Case("pad", lambda P, x: P.pad(x, [1, 0, 2, 1], data_format="NHWC"),
         [R.f(1, 3, 4, 2)], grad=True, tag="nhwc"),
    Case("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, axis=1),
         [x234], grad=True),
    Case("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2),
         [f34], tag="flat"),
    Case("repeat_interleave", lambda P, x, r: P.repeat_interleave(x, r,
                                                                  axis=1),
         [x234, np.array([1, 2, 0], np.int64)], grad=True, tag="tensor"),
    Case("take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1),
         [f34, np.array([[0, 3], [1, 1], [2, 0]], np.int64)], grad=True),
    Case("put_along_axis", lambda P, x, i, v: P.put_along_axis(x, i, v, 1),
         [f34, np.array([[0], [3], [2]], np.int64), R.f(3, 1)], grad=True),
    Case("put_along_axis", lambda P, x, i: P.put_along_axis(
        x, i, 2.0, 1, reduce="add"),
         [f34, np.array([[0, 0], [3, 1], [2, 2]], np.int64)], tag="add"),
    Case("put_along_axis", lambda P, x, i, v: P.put_along_axis(
        x, i, v, 0, reduce="multiply"),
         [f34, np.array([[0, 1, 2, 0]], np.int64), R.f(1, 4)],
         tag="multiply"),
    Case("rot90", lambda P, x: P.rot90(x), [f34], grad=True),
    Case("rot90", lambda P, x: P.rot90(x, k=-1, axes=[1, 2]), [x234],
         tag="axes"),
    Case("moveaxis", lambda P, x: P.moveaxis(x, 0, 2), [x234], grad=True),
    Case("swapaxes", lambda P, x: P.swapaxes(x, 0, 2), [x234], grad=True),
    Case("tensordot", lambda P, x, y: P.tensordot(x, y, axes=1),
         [f34, R.f(4, 5)], grad=True),
    Case("tensordot", lambda P, x, y: P.tensordot(x, y,
                                                  axes=[[1, 2], [1, 2]]),
         [x234, R.f(5, 3, 4)], grad=True, tag="lists"),
    Case("as_real", lambda P, x: P.as_real(x), [cplx]),
    Case("as_complex", lambda P, x: P.as_complex(x), [R.f(3, 2)]),
    Case("crop", lambda P, x: P.crop(x, [1, 2, 2], [1, 1, 1]), [x234],
         grad=True),
    Case("crop", lambda P, x: P.crop(x, [2, 2]), [f34], tag="no_offsets"),
    Case("tolist", lambda P, x: P.tolist(x), [i34]),
    Case("atleast_1d", lambda P, x: P.atleast_1d(x),
         [np.array(2.0, np.float32)], grad=True),
    Case("atleast_2d", lambda P, x, y: P.atleast_2d(x, y),
         [R.f(3), f34], grad=True),
    Case("atleast_3d", lambda P, x: P.atleast_3d(x), [R.f(2)], grad=True),
    Case("atleast_3d", lambda P, x: P.atleast_3d(x), [f34], tag="2d"),
]


# -- ops/creation.py and einsum ----------------------------------------------

R = Rand(5)
f23 = R.f(2, 3)
f44 = R.f(4, 4)
v3 = R.f(3)
_PRINT_DEFAULTS = dict(precision=8, threshold=1000, edgeitems=3,
                       linewidth=75)

CREATION_CASES = [
    Case("create_array", lambda P, x: P.create_array("float32", [x, x]),
         [f23]),
    Case("create_array", lambda P: P.create_array(), tag="empty"),
    Case("array_length", lambda P, x: P.array_length(
        P.create_array("float32", [x, x])), [f23]),
    Case("array_read", lambda P, x, y: P.array_read([x, y], 1), [f23, f23]),
    Case("array_write", lambda P, x, y: P.array_write(y, 0, P.array_write(
        x, 0)), [f23, R.f(2, 3)]),
    Case("set_printoptions",
         lambda P: P.set_printoptions(**_PRINT_DEFAULTS)),
    Case("to_string", lambda P, x: P.to_string(x), [f23]),
    Case("to_string", lambda P, x: P.to_string(x), [R.i(0, 5, 4)],
         tag="int"),
    Case("zeros", lambda P: P.zeros([2, 3])),
    Case("zeros", lambda P: P.zeros([2], "int64"), tag="int64"),
    Case("ones", lambda P: P.ones([2], dtype="int32")),
    Case("ones", lambda P: P.ones(3), tag="int_shape"),
    Case("full", lambda P: P.full([2, 2], 7)),
    Case("full", lambda P: P.full([2], 1.5), tag="float"),
    Case("full", lambda P: P.full([2], True), tag="bool"),
    Case("full", lambda P: P.full([2], 3, dtype="float64"), tag="dtype"),
    Case("zeros_like", lambda P, x: P.zeros_like(x), [f23], grad=True),
    Case("ones_like", lambda P, x: P.ones_like(x, "int32"), [f23]),
    Case("full_like", lambda P, x: P.full_like(x, 3.0), [f23], grad=True),
    Case("full_like", lambda P, x: P.full_like(x, 2), [R.i(0, 3, 4)],
         tag="int"),
    Case("arange", lambda P: P.arange(5)),
    Case("arange", lambda P: P.arange(1, 7, 2), tag="step"),
    Case("arange", lambda P: P.arange(0.0, 1.0, 0.25), tag="float"),
    Case("arange", lambda P: P.arange(4, dtype="float32"), tag="dtype"),
    Case("linspace", lambda P: P.linspace(0, 1, 5)),
    Case("linspace", lambda P: P.linspace(-2, 3, 7, dtype="float64"),
         tag="float64"),
    Case("logspace", lambda P: P.logspace(0, 2, 3), tol=dict(rtol=1e-6,
                                                             atol=1e-5)),
    Case("eye", lambda P: P.eye(3)),
    Case("eye", lambda P: P.eye(2, 3, "int32"), tag="rect"),
    Case("empty", lambda P: P.empty([2, 3])),
    Case("empty_like", lambda P, x: P.empty_like(x), [f23]),
    Case("tril", lambda P, x: P.tril(x, 1), [f44], grad=True),
    Case("triu", lambda P, x: P.triu(x, -1), [f44], grad=True),
    Case("diag", lambda P, x: P.diag(x), [v3], grad=True),
    Case("diag", lambda P, x: P.diag(x), [f44], grad=True, tag="matrix"),
    Case("diag", lambda P, x: P.diag(x, 1, padding_value=9.0), [v3],
         grad=True, tag="padding"),
    Case("diagflat", lambda P, x: P.diagflat(x, -1), [f23], grad=True),
    Case("meshgrid", lambda P, x, y: P.meshgrid(x, y), [v3, R.f(2)],
         grad=True),
    Case("meshgrid", lambda P, x, y: P.meshgrid([x, y]), [v3, R.f(2)],
         tag="list"),
    Case("assign", lambda P, x: P.assign(x), [f23], grad=True),
    Case("assign", lambda P: P.assign(np.arange(4.0)), tag="numpy"),
    Case("assign", lambda P, x, y: P.assign(x, y), [f23, R.f(2, 3)],
         tag="output"),
    Case("clone", lambda P, x: P.clone(x), [f23], grad=True),
    Case("numel", lambda P, x: P.numel(x), [f23]),
    Case("complex_", lambda P, x, y: P.complex_(x, y), [v3, R.f(3)]),
    Case("as_tensor", lambda P: P.as_tensor(np.arange(3.0))),
    Case("as_tensor", lambda P: P.as_tensor([1, 2], dtype="int32"),
         tag="dtype"),
    Case("einsum", lambda P, x, y: P.einsum("ij,jk->ik", x, y),
         [R.f(3, 4), R.f(4, 5)], grad=True),
    Case("einsum", lambda P, x: P.einsum("bij->bji", x), [R.f(2, 3, 4)],
         grad=True, tag="transpose"),
]


# -- ops/search.py ---------------------------------------------------------

R = Rand(29)
cond34 = R.f(3, 4) > 0
f35 = R.f(3, 5)
ties = np.array([1, 3, 3, 2, 3], np.float32)
ints35 = R.i(0, 4, 3, 5)

SEARCH_CASES = [
    Case("where", lambda P, c, x, y: P.where(c, x, y),
         [cond34, R.f(3, 4), R.f(3, 4)], grad=True),
    Case("where", lambda P, c, x: P.where(c, x, 0.0), [cond34, R.f(3, 4)],
         tag="scalar"),
    Case("where", lambda P, c: P.where(c), [cond34], tag="nonzero"),
    Case("argmax", lambda P, x: P.argmax(x), [f35], tag="flat"),
    Case("argmax", lambda P, x: P.argmax(x, axis=1, keepdim=True), [f35],
         tag="keepdim"),
    Case("argmax", lambda P, x: P.argmax(x, axis=0, dtype="int32"), [ints35],
         tag="ties_int32"),
    Case("argmax", lambda P, x: P.argmax(x, keepdim=True), [f35],
         id="argmax_none_drops_keepdim"),
    Case("argmin", lambda P, x: P.argmin(x, axis=-1), [ints35]),
    Case("argmin", lambda P, x: P.argmin(x), [f35], tag="flat"),
    Case("argsort", lambda P, x: P.argsort(x, axis=1), [ints35]),
    Case("argsort", lambda P, x: P.argsort(x, descending=True),
         [np.array([1, 2, 1, 2, 3, 3], np.float32)],
         id="argsort_descending_ties"),
    Case("sort", lambda P, x: P.sort(x, axis=0), [f35], grad=True),
    Case("sort", lambda P, x: P.sort(x, descending=True), [f35], grad=True,
         tag="descending"),
    Case("topk", lambda P, x: P.topk(x, 2), [f35], grad=True),
    Case("topk", lambda P, x: P.topk(x, 2, axis=0, largest=False), [f35],
         grad=True, tag="axis0_smallest"),
    Case("topk", lambda P, x: P.topk(x, 2), [ties],
         id="topk_ties_lowest_index"),
    Case("topk", lambda P, x: P.topk(x, 2, largest=False),
         [np.array([1, 3, 1, 2, 1], np.float32)], id="topk_smallest_ties"),
    Case("topk", lambda P, x, k: P.topk(x, k, sorted=False),
         [ints35, np.array(3, np.int64)], tag="tensor_k_always_sorted"),
    Case("nonzero", lambda P, x: P.nonzero(x), [ints35]),
    Case("nonzero", lambda P, x: P.nonzero(x, as_tuple=True), [ints35],
         tag="as_tuple"),
    Case("masked_select", lambda P, x, m: P.masked_select(x, m),
         [R.f(3, 4), cond34]),
    Case("index_sample", lambda P, x, i: P.index_sample(x, i),
         [f35, np.array([[0, 4], [1, 1], [3, -1]], np.int64)], grad=True),
    Case("index_sample", lambda P, x, i: P.index_sample(x, i),
         [ints35, np.array([[2], [0], [4]], np.int32)], tag="int32"),
    Case("searchsorted", lambda P, s, v: P.searchsorted(s, v),
         [np.array([1.0, 2.0, 2.0, 5.0], np.float32),
          np.array([[0.5, 2.0], [2.5, 9.0]], np.float32)]),
    Case("searchsorted", lambda P, s, v: P.searchsorted(
        s, v, out_int32=True, right=True),
         [np.sort(R.i(0, 9, 2, 3, 5), -1), R.i(0, 9, 2, 3, 4)],
         tag="batched_right_int32"),
    Case("searchsorted", lambda P, s, v: P.searchsorted(s, v),
         [np.array([1, 2, 3], np.int64), np.array([1.5, 2.0], np.float32)],
         tag="mixed_dtypes"),
    Case("kthvalue", lambda P, x: P.kthvalue(x, 2), [f35], grad=True),
    Case("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=0, keepdim=True),
         [ints35], id="kthvalue_ties"),
    Case("mode", lambda P, x: P.mode(x),
         [np.array([[3, 1, 3, 1, 2], [4, 4, 0, 0, 0], [5, 2, 7, 9, 1]],
                   np.int64)], id="mode_smallest_and_count"),
    Case("mode", lambda P, x: P.mode(x, axis=0, keepdim=True),
         [np.array([[1.5, 2, 2], [1.5, 0, 2], [7, 0, 3]], np.float32)],
         tag="axis0_keepdim"),
]


# -- ops/logic.py --------------------------------------------------------------

R = Rand(31)
li = R.i(-3, 4, 3, 4)
lj = R.i(-3, 4, 3, 4)
lf = R.i(-2, 3, 3, 4).astype(np.float32)
lb, lc = R.i(0, 2, 3, 4).astype(bool), R.i(0, 2, 3, 4).astype(bool)
near = (lf + np.float32(1e-7)).astype(np.float32)
nan_a = np.array([1.0, np.nan, 3.0], np.float32)

LOGIC_CASES = [
    Case("equal", lambda P, x, y: P.equal(x, y), [li, lj]),
    Case("equal", lambda P, x: P.equal(x, 1), [lf], tag="scalar"),
    Case("equal", lambda P, x, y: x == y, [lf, li], tag="dunder_mixed"),
    Case("not_equal", lambda P, x, y: P.not_equal(x, y), [li, lj]),
    Case("not_equal", lambda P, x, y: x != y, [lf, R.f(1, 4)],
         tag="dunder_broadcast"),
    Case("greater_than", lambda P, x, y: P.greater_than(x, y), [li, lj]),
    Case("greater_than", lambda P, x: x > 0.5, [lf], tag="dunder"),
    Case("greater_equal", lambda P, x, y: P.greater_equal(x, y), [lf, li]),
    Case("greater_equal", lambda P, x: x >= 0, [li], tag="dunder"),
    Case("less_than", lambda P, x, y: P.less_than(x, y), [li, lj]),
    Case("less_than", lambda P, x, y: x < y, [lf, li], tag="dunder"),
    Case("less_equal", lambda P, x, y: P.less_equal(x, y), [li, lj]),
    Case("less_equal", lambda P, x: x <= 1, [lf], tag="dunder"),
    Case("equal_all", lambda P, x, y: P.equal_all(x, y), [li, li.copy()]),
    Case("equal_all", lambda P, x, y: P.equal_all(x, y), [li, lj],
         tag="values"),
    Case("equal_all", lambda P, x, y: P.equal_all(x, y), [li, li[:2]],
         tag="shapes"),
    Case("allclose", lambda P, x, y: P.allclose(x, y), [lf, near]),
    Case("allclose", lambda P, x, y: P.allclose(x, y, rtol=0.0, atol=0.0),
         [R.f(3), R.f(3)], tag="far"),
    Case("allclose", lambda P, x: P.allclose(x, x, equal_nan=True), [nan_a],
         tag="equal_nan"),
    Case("isclose", lambda P, x, y: P.isclose(x, y), [lf, near]),
    Case("isclose", lambda P, x: P.isclose(x, x), [nan_a], tag="nan"),
    Case("isclose", lambda P, x, y: P.isclose(x, y), [li, lj.astype(np.int32)],
         tag="int"),
    Case("logical_and", lambda P, x, y: P.logical_and(x, y), [lb, lc]),
    Case("logical_and", lambda P, x, y: P.logical_and(x, y), [lf, li],
         tag="numbers"),
    Case("logical_or", lambda P, x, y: P.logical_or(x, y), [lb, lc]),
    Case("logical_xor", lambda P, x, y: P.logical_xor(x, y), [lb, lf],
         tag="mixed"),
    Case("logical_not", lambda P, x: P.logical_not(x), [lb]),
    Case("logical_not", lambda P, x: P.logical_not(x), [lf], tag="float"),
    Case("logical_not", lambda P, x: ~x, [lb], tag="dunder"),
    Case("bitwise_and", lambda P, x, y: P.bitwise_and(x, y), [li, lj]),
    Case("bitwise_and", lambda P, x, y: x & y, [lb, lc], tag="dunder_bool"),
    Case("bitwise_or", lambda P, x, y: P.bitwise_or(x, y),
         [li.astype(np.int32), lj.astype(np.int32)]),
    Case("bitwise_or", lambda P, x, y: x | y, [li, lj], tag="dunder"),
    Case("bitwise_xor", lambda P, x, y: P.bitwise_xor(x, y), [li, lj]),
    Case("bitwise_xor", lambda P, x, y: x ^ y, [lb, lc], tag="dunder"),
    Case("bitwise_not", lambda P, x: P.bitwise_not(x), [li]),
    Case("bitwise_not", lambda P, x: ~x, [li.astype(np.int32)],
         tag="dunder"),
    Case("is_empty", lambda P, x: P.is_empty(x), [li]),
    Case("is_empty", lambda P, x: P.is_empty(x), [np.zeros((0, 3), np.float32)],
         tag="empty"),
    Case("is_tensor", lambda P, x: (P.is_tensor(x), P.is_tensor(li),
                                    P.is_tensor([1, 2])), [lf]),
]


# -- ops/stat.py ---------------------------------------------------------------

R = Rand(37)
s45 = R.f(4, 5)
s234 = R.f(2, 3, 4)
nan45 = s45.copy()
nan45[0, 1] = nan45[2, 3] = nan45[2, 0] = np.nan
nan45[3] = np.nan

STAT_CASES = [
    Case("var", lambda P, x: P.var(x), [s45], grad=True),
    Case("var", lambda P, x: P.var(x, axis=[0, 2], unbiased=False,
                                   keepdim=True), [s234], grad=True,
         tag="axes_biased"),
    Case("var", lambda P, x: P.var(x, axis=1), [R.i(0, 9, 3, 4, dtype="int32")],
         tag="int32"),
    Case("var", lambda P, x: P.var(x, axis=0), [R.i(0, 9, 3, 4)],
         tag="int64"),
    Case("std", lambda P, x: P.std(x, axis=1), [s45], grad=True),
    Case("std", lambda P, x: P.std(x, unbiased=False, keepdim=True), [s234],
         grad=True, tag="all_biased"),
    Case("median", lambda P, x: P.median(x),
         [np.array([1, 2, 3, 4], np.float32)], id="median_even_count"),
    Case("median", lambda P, x: P.median(x, axis=1), [s45], grad=True,
         tag="odd"),
    Case("median", lambda P, x: P.median(x, axis=0, keepdim=True), [s45],
         grad=True, tag="even_keepdim"),
    Case("median", lambda P, x: P.median(x, axis=[0, 2]), [s234], grad=True,
         tag="axes"),
    Case("median", lambda P, x: P.median(x, axis=1), [nan45], tag="nan"),
    Case("median", lambda P, x: P.median(x, axis=1), [R.i(0, 9, 3, 4)],
         tag="int64"),
    Case("nanmedian", lambda P, x: P.nanmedian(x, axis=1), [nan45]),
    Case("nanmedian", lambda P, x: P.nanmedian(x, axis=0, keepdim=True),
         [nan45], tag="keepdim"),
    Case("nanmedian", lambda P, x: P.nanmedian(x), [s45], grad=True,
         tag="all"),
    Case("quantile", lambda P, x: P.quantile(x, 0.3), [s45], grad=True),
    Case("quantile", lambda P, x: P.quantile(x, [0.2, 0.5, 0.9], axis=1),
         [s45], grad=True, tag="list_q_first"),
    Case("quantile", lambda P, x: P.quantile(x, [0.25, 0.75], axis=[0, 2],
                                             keepdim=True),
         [s234], grad=True, tag="axes_keepdim"),
    Case("quantile", lambda P, x: P.quantile(x, 0.4, axis=0), [R.i(0, 9, 5, 3)],
         tag="int64"),
] + [
    Case("quantile", lambda P, x, m=m: P.quantile(x, [0.1, 0.35, 0.5, 0.8],
                                                  axis=1, interpolation=m),
         [s45], tag=m)
    for m in ("lower", "higher", "midpoint", "nearest")
] + [
    Case("nanquantile", lambda P, x: P.nanquantile(x, 0.5, axis=1), [nan45]),
    Case("nanquantile", lambda P, x: P.nanquantile(x, [0.1, 0.9], axis=0,
                                                   keepdim=True), [nan45],
         tag="list_keepdim"),
]


# -- ops/linalg.py -------------------------------------------------------------

R = Rand(41)
m33, m34, m43 = R.f(3, 3), R.f(3, 4), R.f(4, 3)
v3, v4 = R.f(3), R.f(4)
b234, b243 = R.f(2, 3, 4), R.f(2, 4, 3)
spd = (m33 @ m33.T + 3 * np.eye(3)).astype(np.float32)
spd_b = np.stack([spd, (m43.T @ m43 + np.eye(3)).astype(np.float32)])
chol = np.linalg.cholesky(spd).astype(np.float32)
well = (m33 + 4 * np.eye(3)).astype(np.float32)
lower = np.tril(well).astype(np.float32)
deficient = np.concatenate([m43[:, :2], m43[:, :1] + m43[:, 1:2]],
                           1).astype(np.float32)
rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 2]], np.float32)


def _eig_invariants(P, x, w, v):
    """A v = w v (residual), the sorted real and imaginary parts of w,
    and |v|'s column norms: what no phase of the vectors changes."""
    xc = P.cast(x, "complex64") if w.dtype != x.dtype else x
    res = P.abs(P.subtract(P.matmul(xc, v), P.multiply(v, P.unsqueeze(w, 0))))
    return (P.max(res) < 1e-4, P.sort(P.real(w)), P.sort(P.imag(w)),
            P.sqrt(P.sum(P.real(P.multiply(v, P.conj(v))), axis=0)))


def _eig(P, x):
    w, v = P.eig(x)
    return _eig_invariants(P, x, w, v)


def _eigvals(P, x):
    w = P.eigvals(x)
    return P.sort(P.real(w)), P.sort(P.imag(w))


def _svd(P, x):
    u, s, vh = P.svd(x)
    return s, P.matmul(P.multiply(u, P.unsqueeze(s, -2)), vh)


def _eigh(P, x, uplo="L"):
    w, v = P.eigh(x, UPLO=uplo)
    return w, P.matmul(P.multiply(v, P.unsqueeze(w, -2)), P.t(v))


def _qr(P, x, mode="reduced"):
    q, r = P.qr(x, mode=mode)
    return P.matmul(q, r), P.abs(r), P.matmul(P.t(q), q)


LINALG_CASES = [
    Case("matmul", lambda P, x, y: P.matmul(x, y), [m34, m43], grad=True),
    Case("matmul", lambda P, x, y: P.matmul(x, y, transpose_x=True,
                                            transpose_y=True),
         [b243, R.f(2, 3, 4)], grad=True, tag="transposes_batched"),
    Case("matmul", lambda P, x, y: P.matmul(x, y, transpose_x=True,
                                            transpose_y=True),
         [v3, m43], grad=True, id="matmul_transpose_1d"),
    Case("matmul", lambda P, x, y: P.matmul(x, y), [v4, v4], grad=True,
         tag="vectors"),
    Case("matmul", lambda P, x, y: x @ y, [m34, v4], grad=True,
         tag="dunder_matrix_vector"),
    Case("matmul", lambda P, x, y: P.matmul(x, y),
         [R.i(-3, 4, 2, 3), R.i(-3, 4, 3, 2)], tag="int"),
    Case("matmul", lambda P, x, y: P.matmul(x, y),
         [R.i(-3, 4, 3, dtype="int32"), R.i(-3, 4, 2, 3, 2)],
         tag="int_vector_batched"),
    Case("matmul", lambda P, x, y: P.matmul(x, y),
         [m34, m43.astype(np.float64)], tag="f32_f64"),
    Case("mm", lambda P, x, y: P.mm(x, y), [m34, m43], grad=True),
    Case("bmm", lambda P, x, y: P.bmm(x, y), [b234, b243], grad=True),
    Case("mv", lambda P, x, y: P.mv(x, y), [m34, v4], grad=True),
    Case("dot", lambda P, x, y: P.dot(x, y), [v4, R.f(4)], grad=True),
    Case("dot", lambda P, x, y: P.dot(x, y), [m34, R.f(3, 4)], grad=True,
         id="dot_rows"),
    Case("dot", lambda P, x, y: P.dot(x, y),
         [R.i(0, 5, 3, 4, dtype="int32"), R.i(0, 5, 3, 4, dtype="int32")],
         tag="int32"),
    Case("t", lambda P, x: P.t(x), [m34], grad=True),
    Case("t", lambda P, x: P.t(x), [b234], grad=True, id="t_3d"),
    Case("t", lambda P, x: P.t(x), [v3], tag="1d"),
    Case("norm", lambda P, x: P.norm(x), [b234], grad=True,
         id="norm_fro_all"),
    Case("norm", lambda P, x: P.norm(x, axis=[0, 2], keepdim=True), [b234],
         grad=True, id="norm_fro_axes"),
    Case("norm", lambda P, x: P.norm(x, p="nuc"), [b234], grad=True,
         tol=TRANS, id="norm_nuc"),
    Case("norm", lambda P, x: P.norm(x, p=0, axis=1),
         [R.i(-1, 2, 3, 4).astype(np.float32)], id="norm_p0_count"),
    Case("norm", lambda P, x: P.norm(x, p=np.inf, axis=-1, keepdim=True),
         [m34], grad=True, id="norm_inf"),
    Case("norm", lambda P, x: P.norm(x, p="-inf", axis=0), [m34],
         grad=True, id="norm_neg_inf"),
    Case("norm", lambda P, x: P.norm(x, p=3, axis=1), [m34], grad=True,
         tol=TRANS, id="norm_general_p"),
    Case("norm", lambda P, x: P.norm(x, p=1, keepdim=True), [b234],
         grad=True, id="norm_axis_none_flattens"),
    Case("norm", lambda P, x: P.norm(x, p=np.inf, axis=[0, 1]), [m34],
         grad=True, id="norm_matrix_axes"),
    Case("dist", lambda P, x, y: P.dist(x, y), [m34, R.f(3, 4)], grad=True),
    Case("dist", lambda P, x, y: P.dist(x, y, p=0), [m34, m34[:1]],
         tag="p0_broadcast"),
    Case("dist", lambda P, x, y: P.dist(x, y, p=np.inf), [m34, R.f(3, 4)],
         grad=True, tag="inf"),
    Case("dist", lambda P, x, y: P.dist(x, y, p=1.5), [m34, R.f(3, 4)],
         grad=True, tol=TRANS, tag="p1.5"),
    Case("cholesky", lambda P, x: P.cholesky(x), [spd], grad=True),
    Case("cholesky", lambda P, x: P.cholesky(x, upper=True), [spd_b],
         grad=True, tag="upper_batched"),
    Case("inv", lambda P, x: P.inv(x), [well], grad=True),
    Case("inverse", lambda P, x: P.inverse(x), [spd_b], grad=True),
    Case("det", lambda P, x: P.det(x), [well], grad=True),
    Case("det", lambda P, x: P.det(x), [spd_b], grad=True, tag="batched"),
    Case("slogdet", lambda P, x: P.slogdet(x), [m33], grad=True),
    Case("svd", _svd, [m34], grad=True, tol=TRANS),
    Case("svd", lambda P, x: _svd(P, x)[0], [b243], grad=True, tol=TRANS,
         tag="batched_values"),
    Case("qr", _qr, [m43], tol=TRANS),
    Case("qr", lambda P, x: P.abs(P.qr(x, mode="r")), [m43], tol=TRANS,
         id="qr_mode_r_single"),
    Case("qr", lambda P, x: _qr(P, x, "complete"), [m43], tol=TRANS,
         tag="complete"),
    Case("eig", _eig, [m33], tol=TRANS),
    Case("eig", _eig, [rot], tol=TRANS, id="eig_complex"),
    Case("eig", lambda P, x: [t.dtype == P.complex64 for t in P.eig(x)],
         [rot], tag="dtype"),
    Case("eigvals", _eigvals, [rot], tol=TRANS),
    Case("eigvals", _eigvals, [spd], tol=TRANS, tag="real"),
    Case("eigh", _eigh, [spd], tol=TRANS),
    Case("eigh", lambda P, x: _eigh(P, x, "U"), [well], tol=TRANS,
         id="eigh_upper_ignored"),
    Case("eigvalsh", lambda P, x: P.eigvalsh(x), [well], grad=True,
         tol=TRANS, id="eigvalsh_symmetrizes"),
    Case("solve", lambda P, x, y: P.solve(x, y), [well, m34], grad=True),
    Case("solve", lambda P, x, y: P.solve(x, y), [well, v3], grad=True,
         tag="vector"),
    Case("triangular_solve", lambda P, x, y: P.triangular_solve(
        x, y, upper=False), [lower, m34], grad=True),
    Case("triangular_solve", lambda P, x, y: P.triangular_solve(
        x, y, transpose=True, unitriangular=True), [well, m34], grad=True,
         tag="upper_transpose_unit"),
    Case("cholesky_solve", lambda P, b, f: P.cholesky_solve(b, f),
         [m34, chol], grad=True),
    Case("cholesky_solve", lambda P, b, f: P.cholesky_solve(b, f,
                                                            upper=True),
         [m34, chol.T.copy()], grad=True, tag="upper"),
    Case("matrix_power", lambda P, x: P.matrix_power(x, 3), [m33],
         grad=True),
    Case("matrix_power", lambda P, x: P.matrix_power(x, -2), [well],
         grad=True, tol=TRANS, tag="negative"),
    Case("pinv", lambda P, x: P.pinv(x), [m34], grad=True, tol=TRANS),
    Case("pinv", lambda P, x: P.pinv(x, rcond=1e-3), [deficient],
         tol=TRANS, tag="relative_rcond"),
    Case("cross", lambda P, x, y: P.cross(x, y), [m34, R.f(3, 4)],
         grad=True, id="cross_axis_9"),
    Case("cross", lambda P, x, y: P.cross(x, y, axis=1), [m43, R.f(4, 3)],
         grad=True, tag="axis1"),
    Case("histogram", lambda P, x: P.histogram(x, bins=4),
         [np.array([2.0, 2.0, 2.0], np.float32)],
         id="histogram_int64_and_degenerate_range"),
    Case("histogram", lambda P, x: P.histogram(x, bins=7), [R.f(50)],
         tag="data_range"),
    Case("histogram", lambda P, x: P.histogram(x, bins=5, min=-1, max=1),
         [R.f(60)], tag="min_max"),
    Case("histogram", lambda P, x: P.histogram(x, bins=3, min=1, max=3),
         [R.i(0, 5, 20, dtype="int32")], tag="int"),
    Case("bincount", lambda P, x: P.bincount(x), [R.i(0, 6, 20)]),
    Case("bincount", lambda P, x, w: P.bincount(x, weights=w, minlength=9),
         [R.i(0, 6, 20, dtype="int32"), R.f(20)], id="bincount_minlength"),
    Case("matrix_rank", lambda P, x: P.matrix_rank(x), [deficient]),
    Case("matrix_rank", lambda P, x: P.matrix_rank(x, tol=0.5),
         [np.diag([3.0, 1.0, 0.4]).astype(np.float32)], tag="absolute_tol"),
    Case("matrix_rank", lambda P, x: P.matrix_rank(x), [b243],
         tag="batched"),
    Case("lu", lambda P, x: P.lu(x), [m33], id="lu_pivots_one_based"),
    Case("lu", lambda P, x: P.lu(x, get_infos=True), [spd_b],
         tag="infos_batched"),
    Case("lstsq", lambda P, x, y: P.lstsq(x, y), [m43, R.f(4, 2)],
         tol=TRANS),
    Case("lstsq", lambda P, x, y: P.lstsq(x, y, rcond=1e-3), [deficient, v4],
         tol=TRANS, id="lstsq_rank_deficient"),
    Case("multi_dot", lambda P, x, y, z: P.multi_dot([x, y, z]),
         [m34, m43, m33], grad=True),
    Case("cov", lambda P, x: P.cov(x), [m34], grad=True),
    Case("cov", lambda P, x: P.cov(x, rowvar=False, ddof=False), [m43],
         grad=True, tag="columns_biased"),
    Case("cov", lambda P, x, f, a: P.cov(x, fweights=f, aweights=a),
         [m34, np.array([1, 2, 3, 1], np.int64), R.u(0.1, 1, 4)],
         id="cov_weights_ignored"),
    Case("cov", lambda P, x: P.cov(x), [R.i(0, 5, 3, 4, dtype="int32")],
         tag="int32"),
    Case("corrcoef", lambda P, x: P.corrcoef(x), [m34], grad=True,
         tol=TRANS),
    Case("corrcoef", lambda P, x: P.corrcoef(x, rowvar=False),
         [R.i(0, 9, 5, 3)], tol=TRANS, tag="int64_columns"),
    Case("rank", lambda P, x: P.rank(x), [b234]),
]

ALL_CASES = (MATH_CASES + MANIPULATION_CASES + CREATION_CASES + SEARCH_CASES
             + LOGIC_CASES + STAT_CASES + LINALG_CASES)


# -- ops/random.py: laws ---------------------------------------------------------

N_DRAWS = 200_000
_P_CAT = np.array([0.1, 0.0, 0.6, 0.3], np.float32)   # index mean 2.1


def _disc(k):
    """Variance and fourth central moment of a uniform integer on k
    values."""
    return (k * k - 1) / 12, (k * k - 1) * (3 * k * k - 7) / 240


class Law:
    """`draw(P, n)`: about n draws of one law as a paddle Tensor of
    `dtype`; `support(values)` true for every draw; the law's mean,
    variance and (where given) fourth central moment."""

    def __init__(self, id, draw, dtype, support, mean, var, mu4=None):
        self.id, self.draw, self.dtype, self.support = id, draw, dtype, support
        self.mean, self.var, self.mu4 = mean, var, mu4


def _ints(lo, hi):
    return lambda a: bool(np.all(a == np.round(a)) and a.min() >= lo
                          and a.max() <= hi and len(np.unique(a))
                          == hi - lo + 1)


def _finite(a):
    return bool(np.isfinite(a).all())


def _within(lo, hi):
    return lambda a: bool(a.min() >= lo and a.max() < hi)


def _rows(P, n):
    return P.to_tensor(np.tile(_P_CAT, (n // 10, 1)))


RANDOM_LAWS = [
    Law("uniform", lambda P, n: P.uniform([n], min=-1.0, max=3.0),
        "float32", _within(-1.0, 3.0), 1.0, 16 / 12, 4 ** 4 / 80),
    Law("rand", lambda P, n: P.rand([n]), "float32", _within(0.0, 1.0),
        0.5, 1 / 12, 1 / 80),
    Law("uniform_", lambda P, n: P.uniform_(P.zeros([n]), min=2.0, max=4.0),
        "float32", _within(2.0, 4.0), 3.0, 4 / 12, 2 ** 4 / 80),
    Law("randn", lambda P, n: P.randn([n]), "float32", _finite, 0.0,
        1.0, 3.0),
    Law("standard_normal", lambda P, n: P.standard_normal([n], "float64"),
        "float64", _finite, 0.0, 1.0, 3.0),
    Law("normal", lambda P, n: P.normal(2.0, 3.0, [n]), "float32",
        _finite, 2.0, 9.0, 3 * 81.0),
    Law("normal-tensor_mean", lambda P, n: P.normal(P.full([n], -5.0), 2.0),
        "float32", _finite, -5.0, 4.0, 48.0),
    Law("gaussian", lambda P, n: P.gaussian([n], mean=-1.0, std=0.5),
        "float32", _finite, -1.0, 0.25, 3 * 0.0625),
    Law("randint", lambda P, n: P.randint(3, 9, [n]), "int64", _ints(3, 8),
        5.5, *_disc(6)),
    Law("randint-low_only", lambda P, n: P.randint(4, shape=[n]), "int64",
        _ints(0, 3), 1.5, *_disc(4)),
    Law("randint_like", lambda P, n: P.randint_like(P.zeros([n]), 10),
        "float32", _ints(0, 9), 4.5, *_disc(10)),
    Law("randperm", lambda P, n: P.randperm(n), "int64",
        lambda a: bool(np.array_equal(np.sort(a), np.arange(a.size))),
        (N_DRAWS - 1) / 2, (N_DRAWS ** 2 - 1) / 12),
    Law("bernoulli", lambda P, n: P.bernoulli(P.full([n], 0.3)), "float32",
        _ints(0, 1), 0.3, 0.21, 0.21 * (1 - 3 * 0.21)),
    Law("bernoulli-float16", lambda P, n: P.bernoulli(
        P.full([n], 0.3, "float16")), "float16", _ints(0, 1), 0.3, 0.21,
        0.21 * (1 - 3 * 0.21)),
    Law("poisson", lambda P, n: P.poisson(P.full([n], 3.0)), "float32",
        lambda a: bool(np.all(a == np.round(a)) and a.min() >= 0), 3.0, 3.0,
        3.0 * (1 + 3 * 3.0)),
    Law("exponential_", lambda P, n: P.exponential_(P.zeros([n]), lam=2.0),
        "float32", lambda a: bool(a.min() >= 0), 0.5, 0.25, 9 / 16),
    Law("multinomial-replacement", lambda P, n: P.multinomial(
        _rows(P, n), 10, replacement=True), "int64",
        lambda a: set(np.unique(a)) == {0, 2, 3}, 2.1, 0.69, 2.14170),
    Law("multinomial-first_of_3", lambda P, n: P.multinomial(
        _rows(P, n), 3)[:, 0], "int64",
        lambda a: set(np.unique(a)) == {0, 2, 3}, 2.1, 0.69, 2.14170),
]


def law_errors(law, a):
    """The draws `a` (numpy) against `law`: the sample mean's and
    variance's distance from the law's in standard errors (the variance's
    None without a fourth moment); raises AssertionError on a draw outside
    the support or a distance above 5."""
    a = np.asarray(a, np.float64).ravel()
    n = a.size
    assert law.support(a), (law.id, "support")
    zm = abs(a.mean() - law.mean) / np.sqrt(law.var / n)
    zv = None if law.mu4 is None else \
        abs(a.var() - law.var) / np.sqrt((law.mu4 - law.var ** 2) / n)
    assert zm <= 5 and (zv is None or zv <= 5), (law.id, zm, zv)
    return zm, zv
