"""The op cases of the eager API, written once against the public API
both packages share (`P` is ``paddle_tpu`` or ``paddle_tpu_torch``). It
imports neither package nor JAX: tests/test_torch_ops.py runs each case
on both packages on the CPU, and chip_smoke.py's phase 22 runs each on
the port's CUDA and CPU Tensors.

A case is (name, fn, opts): ``fn(P, T)`` builds its inputs through
``T(array)`` (a Tensor that requires a grad when the array is float,
unless ``T(array, grad=False)``) from the fixed numpy arrays below, and
returns a Tensor or a tuple or list of them. ``run_case`` then seeds
each float output that requires a grad with a fixed cotangent, runs
``backward()`` and reads the inputs' grads. opts: ``tol`` (the values'
rtol = atol), ``grad_tol`` and ``grad=False`` (no backward: the op or
its gradient is not defined on these inputs, or differs by
construction, as a decomposition's sign).

The cases hold the tables of tests/test_ops_math.py and
test_ops_torch_oracle.py and the in-slice cases of test_ops_oracle_r3.py
(their inputs), and one case or more for every op of the slice's
``OPS`` table. Random ops are not here: their draws differ by design
(tests/test_torch_generator.py, phase 22's moments)."""
import numpy as np

# the draws of f32/pos: the module's arrays at import, then a case's
# own draws from a generator run_case reseeds before each case, so both
# packages and both devices get the same inputs
_rng = [np.random.default_rng(20240601)]


def f32(*shape, lo=-1.0, hi=1.0):
    return _rng[0].uniform(lo, hi, shape).astype(np.float32)


def pos(*shape):
    return f32(*shape, lo=0.5, hi=2.0)


A23, A34, A45, A345 = f32(2, 3), f32(3, 4), f32(4, 5), f32(3, 4, 5)
B34, V8, V6 = f32(3, 4), f32(8), f32(6)
P34 = pos(3, 4)
U34 = f32(3, 4, lo=-0.9, hi=0.9)          # inside (-1, 1)
SPD = (lambda m: (m @ m.T + 3 * np.eye(4)).astype(np.float32))(f32(4, 4))
SQ = (f32(4, 4) + 3 * np.eye(4)).astype(np.float32)
SYM = ((lambda m: m + m.T)(f32(4, 4))).astype(np.float32)
TRIL = (np.tril(f32(4, 4)) + 3 * np.eye(4)).astype(np.float32)
IMG = f32(2, 4, 8, 8)                     # NCHW
IMG3 = f32(1, 3, 4, 6, 6)                 # NCDHW
SEQ = f32(2, 4, 16)                       # NCL
I34 = _rng[0].integers(-20, 20, (3, 4)).astype(np.int32)
J34 = _rng[0].integers(1, 9, (3, 4)).astype(np.int32)
BOOL34 = A34 > 0
CPLX = (A23 + 1j * A23[::-1]).astype(np.complex64)
QKV = f32(2, 128, 2, 64)                  # [b, s, h, d] (the flash shape)


def ints(*vals):
    return np.array(vals, np.int32)


CASES = []


def case(name, fn, **opts):
    CASES.append((name, fn, opts))


def unary(op, x, **opts):
    case(op, lambda P, T: getattr(P, op)(T(x)), **opts)


# ---------------------------------------------------------------------------
# tests/test_ops_math.py's table
# ---------------------------------------------------------------------------
for _op in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
            "fmin", "atan2", "hypot", "logaddexp", "copysign"):
    case(_op, lambda P, T, op=_op: getattr(P, op)(T(A34), T(B34)))
case("broadcast_add", lambda P, T: P.add(T(A34), T(V8[:4])))
case("divide", lambda P, T: P.divide(T(A34), T(P34)))
case("floor_divide", lambda P, T: P.floor_divide(T(A34 * 10), T(P34)),
     grad=False)
case("mod", lambda P, T: P.mod(T(A34 * 10), T(P34)), grad=False)
case("pow", lambda P, T: P.pow(T(P34), T(A34)))
case("pow_scalar", lambda P, T: P.pow(T(A34), 2.0))
case("heaviside", lambda P, T: P.heaviside(T(A34), T(B34)), grad=False)
case("nextafter", lambda P, T: P.nextafter(T(A34), T(B34)), grad=False)
case("gcd", lambda P, T: P.gcd(T(I34), T(J34)))
case("lcm", lambda P, T: P.lcm(T(J34), T(J34 + 1)))
case("ldexp", lambda P, T: P.ldexp(T(A23), T(ints(1, 2, 3))))
case("int_div", lambda P, T: P.divide(T(I34), T(J34)))
case("int_scalar_promote", lambda P, T: T(I34) * 2.5)
for _op in ("exp", "tanh", "sin", "cos", "abs", "floor", "ceil", "square",
            "sign", "neg", "expm1", "sigmoid", "atan", "sinh", "cosh",
            "asinh", "erf", "trunc", "frac", "logsigmoid", "rad2deg",
            "deg2rad", "i0", "i0e", "i1", "i1e", "isnan", "isinf",
            "isfinite", "stanh", "tan"):
    unary(_op, A34, grad=_op not in ("floor", "ceil", "sign", "trunc",
                                     "isnan", "isinf", "isfinite"))
for _op in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
            "lgamma", "digamma", "acosh"):
    unary(_op, P34 + (1.0 if _op == "acosh" else 0.0), tol=1e-4)
for _op in ("asin", "acos", "atanh", "erfinv", "logit"):
    unary(_op, np.abs(U34) if _op == "logit" else U34, tol=1e-4)
case("round", lambda P, T: P.round(T(A34 * 10)), grad=False)
case("polygamma", lambda P, T: P.polygamma(T(P34), 1), tol=1e-4)
case("clip", lambda P, T: P.clip(T(A34), -0.5, 0.5))
case("nan_to_num", lambda P, T: P.nan_to_num(
    T(np.array([1.0, np.nan, np.inf, -np.inf], np.float32), grad=False)))
case("angle", lambda P, T: P.angle(T(CPLX, grad=False)))
case("conj", lambda P, T: P.conj(T(A23)))
case("real_imag", lambda P, T: (P.real(T(CPLX, grad=False)),
                                P.imag(T(CPLX, grad=False))))
case("multiplex", lambda P, T: P.multiplex(
    [T(A23), T(A23 * 2)], T(np.array([[0], [1]], np.int32))))
case("lerp", lambda P, T: P.lerp(T(A23), T(A23 * 2), 0.3))
case("scale", lambda P, T: P.scale(T(A23), 2.0, 1.0))
case("scale_after", lambda P, T: P.scale(T(A23), 2.0, 1.0,
                                         bias_after_scale=False))
case("increment", lambda P, T: P.increment(T(np.array([1.0], np.float32))))
case("trapezoid", lambda P, T: P.trapezoid(T(V8), dx=0.5))
case("diff", lambda P, T: P.diff(T(A34), axis=1))
case("logcumsumexp", lambda P, T: P.logcumsumexp(T(A34), axis=1))
case("clip_by_norm", lambda P, T: P.clip_by_norm(T(A34), 0.5))
case("renorm", lambda P, T: P.renorm(T(A34), 2.0, 0, 0.5))
case("add_n", lambda P, T: P.add_n([T(A34), T(B34), T(A34)]))
case("elementwise_pow", lambda P, T: P.elementwise_pow(T(P34), T(A34)))
case("remainder", lambda P, T: P.remainder(T(A34 * 5), T(P34)), grad=False)

case("sum", lambda P, T: P.sum(T(A34)))
case("sum_axis", lambda P, T: P.sum(T(A345), axis=1, keepdim=True))
case("sum_int", lambda P, T: P.sum(T(I34), axis=0))
case("mean", lambda P, T: P.mean(T(A34), axis=0))
case("max_min", lambda P, T: (P.max(T(A34), axis=1), P.min(T(A34))))
case("amax_amin", lambda P, T: (P.amax(T(A345), axis=[0, 2]),
                                P.amin(T(A345), axis=-1, keepdim=True)))
case("prod", lambda P, T: P.prod(T(P34[:2, :3])))
case("prod_axis", lambda P, T: P.prod(T(P34), axis=1))
case("logsumexp", lambda P, T: P.logsumexp(T(A34)))
case("var_std", lambda P, T: (P.var(T(A45)), P.std(T(A45), axis=1)))
case("median", lambda P, T: P.median(T(A345), axis=1), tol=1e-5,
     grad=False)
case("nanmedian", lambda P, T: P.nanmedian(
    T(np.array([1., np.nan, 3., 7.], np.float32), grad=False)))
case("nansum_nanmean", lambda P, T: (P.nansum(T(A34), axis=0),
                                     P.nanmean(T(A34))))
case("quantile", lambda P, T: P.quantile(T(A345), 0.25, axis=-1),
     grad=False)
case("nanquantile", lambda P, T: P.nanquantile(
    T(np.array([1., np.nan, 3., 4.], np.float32), grad=False), 0.5))
case("all_any", lambda P, T: (P.all(T(BOOL34)), P.any(T(BOOL34), axis=1)))
case("count_nonzero", lambda P, T: P.count_nonzero(T(I34), axis=1))
case("cumsum", lambda P, T: P.cumsum(T(A34), axis=1))
case("cumprod", lambda P, T: P.cumprod(T(P34), dim=1))
case("cummax_cummin", lambda P, T: (P.cummax(T(A34), axis=1),
                                    P.cummin(T(A34), axis=0)))
case("cumulative_trapezoid",
     lambda P, T: P.cumulative_trapezoid(T(V8), dx=0.5))

case("matmul", lambda P, T: P.matmul(T(A34), T(A45)), tol=1e-5)
case("matmul_transpose", lambda P, T: P.matmul(T(A34), T(B34),
                                               transpose_y=True))
case("batched_matmul", lambda P, T: P.matmul(T(f32(2, 3, 4)),
                                             T(f32(2, 4, 5))))
case("norm", lambda P, T: P.norm(T(A34)))
case("norm_p", lambda P, T: (P.norm(T(A34), p=1, axis=1),
                             P.norm(T(A34), p=float("inf"))))
case("einsum", lambda P, T: P.einsum("ij,jk->ik", T(A34), T(A45)))
case("solve", lambda P, T: P.solve(T(SQ), T(f32(4, 2))), tol=1e-4)
case("cholesky", lambda P, T: P.cholesky(T(SPD)), tol=1e-4)

case("reshape", lambda P, T: P.reshape(T(A34), [2, 6]))
case("transpose", lambda P, T: P.transpose(T(A345), [2, 0, 1]))
case("concat", lambda P, T: P.concat([T(A23), T(A23 * 2)], axis=0))
case("stack_split", lambda P, T: P.split(P.stack([T(A23), T(A23 * 2)],
                                                 axis=0), 2, axis=0))
case("split_sections", lambda P, T: P.split(T(A345), [1, -1], axis=1))
case("chunk_unbind", lambda P, T: (P.chunk(T(A345), 2, axis=1),
                                   P.unbind(T(A34), axis=1)))
case("squeeze_unsqueeze", lambda P, T: (
    P.unsqueeze(T(A34), 1), P.squeeze(T(f32(3, 1, 4)), 1),
    P.unsqueeze(T(A34), [0, 2]), P.squeeze(T(f32(1, 3, 1)))))
case("gather", lambda P, T: P.gather(T(f32(5, 4)), T(ints(0, 2, 4))))
case("where", lambda P, T: P.where(T(BOOL34), T(A34), T(B34)))
case("tile", lambda P, T: P.tile(T(A23), (2, 1)))
case("expand", lambda P, T: P.expand(T(f32(1, 4)), [3, -1]))
case("pad", lambda P, T: P.nn.functional.pad(T(A23), [1, 1, 2, 2],
                                             value=1.0))
case("pad_reflect", lambda P, T: P.nn.functional.pad(
    T(IMG), [1, 2, 2, 1], mode="reflect"))
case("getitem", lambda P, T: (T(A345)[1], T(A345)[1:3, ::2],
                              T(A345)[:, None, 0]))
case("getitem_tensor_index", lambda P, T: T(A345)[T(ints(2, 0), grad=False)])


def _setitem(P, T):
    x = T(A45) * 1.0
    x[1] = 0.0
    x[2:, 1] = T(f32(2))
    return x


case("setitem", _setitem)
case("cast", lambda P, T: (P.cast(T(A34), "int32"),
                           T(A34).astype("float16").astype("float32")),
     grad_tol=1e-3)

case("argmax", lambda P, T: (P.argmax(T(A34), axis=1), P.argmax(T(A34))))
case("argmin", lambda P, T: P.argmin(T(A34), axis=0, keepdim=True))
case("sort_argsort", lambda P, T: (P.sort(T(A34), axis=1),
                                   P.argsort(T(A34), axis=1,
                                             descending=True)))
case("topk", lambda P, T: P.topk(T(f32(3, 10)), k=3))
case("unique", lambda P, T: P.unique(T(ints(1, 3, 1, 2, 3))))
case("unique_full", lambda P, T: P.unique(
    T(np.array([3., 1., 2., 1., 3.], np.float32), grad=False),
    return_index=True, return_inverse=True, return_counts=True))
case("nonzero", lambda P, T: P.nonzero(
    T(np.array([[1, 0], [0, 2]], np.float32), grad=False)))

case("compare", lambda P, T: (T(A34) > T(B34), T(A34) <= 0.1,
                              T(A34) == T(A34), T(A34) != T(B34),
                              T(A34) >= T(B34), T(A34) < T(B34)))
case("allclose_isclose", lambda P, T: (
    P.allclose(T(A23), T(A23 + 1e-9)), P.isclose(T(A23), T(A23 + 1e-9))))
case("logical", lambda P, T: (
    P.logical_and(T(BOOL34), T(A34 < 0.5)),
    P.logical_or(T(BOOL34), T(A34 < 0.5)),
    P.logical_xor(T(BOOL34), T(A34 < 0.5)), P.logical_not(T(BOOL34))))
case("bitwise", lambda P, T: (
    P.bitwise_and(T(I34), T(J34)), P.bitwise_or(T(I34), T(J34)),
    P.bitwise_xor(T(I34), T(J34)), P.bitwise_not(T(I34)),
    T(I34) & T(J34), T(I34) | T(J34), T(I34) ^ T(J34), ~T(I34)))
case("shifts", lambda P, T: (P.bitwise_left_shift(T(J34), T(J34 % 3)),
                             P.bitwise_right_shift(T(J34 * 8), T(J34 % 3))))
case("equal_all", lambda P, T: (P.equal_all(T(A23), T(A23.copy())),
                                P.equal_all(T(A23), T(A23 + 1))))
case("is_empty", lambda P, T: (P.is_empty(T(np.zeros((0, 3), np.float32))),
                               P.is_empty(T(A23))))
case("equal_fns", lambda P, T: (
    P.equal(T(A34), T(B34)), P.not_equal(T(A34), T(B34)),
    P.greater_than(T(A34), T(B34)), P.greater_equal(T(A34), T(B34)),
    P.less_than(T(A34), T(B34)), P.less_equal(T(A34), T(B34))))

# ---------------------------------------------------------------------------
# test_ops_torch_oracle.py's table (the slice's ops)
# ---------------------------------------------------------------------------
case("histogram", lambda P, T: P.histogram(T(V8, grad=False), bins=4,
                                           min=-2, max=2))
case("bincount", lambda P, T: P.bincount(T(ints(0, 1, 1, 3)), minlength=5))
case("kthvalue", lambda P, T: P.kthvalue(T(A345), 2, axis=-1))
case("mode", lambda P, T: P.mode(T(np.array([[1., 2., 2.], [3., 3., 1.]],
                                            np.float32), grad=False)))
case("searchsorted", lambda P, T: P.searchsorted(T(np.sort(V8)), T(A23)))
case("put_along_axis", lambda P, T: P.put_along_axis(
    T(A23), T(np.array([[0], [1]], np.int32)), 9.0, 1))
case("put_along_axis_add", lambda P, T: P.put_along_axis(
    T(A23), T(np.array([[0], [1]], np.int32)), T(f32(2, 1)), 1,
    reduce="add"))
case("take_along_axis", lambda P, T: P.take_along_axis(
    T(A23), T(np.array([[0, 1], [1, 2]], np.int32)), 1))
case("index_select", lambda P, T: P.index_select(T(A345), T(ints(0, 2)), 1))
case("index_add", lambda P, T: P.index_add(T(A23), T(ints(0, 1)), 0,
                                           T(np.ones((2, 3), np.float32))))
case("masked_fill", lambda P, T: P.masked_fill(T(A23), T(A23 > 0), -1.0))
case("masked_select", lambda P, T: P.masked_select(T(A23), T(A23 > 0)))
case("cholesky_solve", lambda P, T: P.cholesky_solve(
    T(f32(4, 2)), T(np.linalg.cholesky(SPD).astype(np.float32)),
    upper=False), tol=1e-4, grad_tol=1e-3)
case("matrix_power", lambda P, T: P.matrix_power(T(SPD / 4), 3), tol=1e-4)
case("svdvals", lambda P, T: P.svdvals(T(A23)), tol=1e-4)
case("pinv", lambda P, T: P.pinv(T(A23)), tol=1e-4, grad_tol=1e-3)
case("dist", lambda P, T: P.dist(T(A23), T(A23 * 0.5), 2.0))
case("cov", lambda P, T: P.cov(T(A23)), tol=1e-5)
case("corrcoef", lambda P, T: P.corrcoef(T(A23)), tol=1e-5)
case("isclose", lambda P, T: P.isclose(T(A23), T(A23 + 1e-9)))
case("diag_embed", lambda P, T: P.diag_embed(T(A23)))
case("diagflat", lambda P, T: P.diagflat(T(V8)))
case("unfold", lambda P, T: P.unfold(T(V8), 0, 3, 2))
case("repeat_interleave", lambda P, T: P.repeat_interleave(T(A23), 2,
                                                           axis=1))
case("gather_nd", lambda P, T: P.gather_nd(T(A345), T(np.array(
    [[0, 1], [2, 3]], np.int32))))
case("strided_slice", lambda P, T: P.strided_slice(T(A345), [1], [0], [4],
                                                   [2]))
case("expand_as", lambda P, T: P.expand_as(T(V8[:1]), T(V8)))

# ---------------------------------------------------------------------------
# test_ops_oracle_r3.py's in-slice cases (its registry tail)
# ---------------------------------------------------------------------------
IDX23 = np.array([[0, 2, 1], [1, 1, 0]], np.int32)
case("bucketize", lambda P, T: P.bucketize(T(A23), T(np.sort(V6))))
case("index_sample", lambda P, T: P.index_sample(T(A23), T(IDX23)))
case("index_fill", lambda P, T: P.index_fill(T(f32(4, 6)), T(ints(0, 2)),
                                             0, -1.0))
case("masked_scatter", lambda P, T: P.masked_scatter(
    T(A23), T(A23 > 0), T(np.ones(6, np.float32))))
case("multi_dot", lambda P, T: P.multi_dot([T(A23), T(B34), T(A45)]),
     tol=1e-5)
case("matrix_norm", lambda P, T: P.matrix_norm(T(f32(4, 6)), "fro"))
case("vector_norm", lambda P, T: P.vector_norm(T(f32(4, 6)), 3.0))
case("matrix_rank", lambda P, T: P.matrix_rank(
    T(np.outer(V6, V6).astype(np.float32), grad=False)))
case("triangular_solve", lambda P, T: P.triangular_solve(
    T(TRIL), T(f32(4, 2)), upper=False), tol=1e-4, grad_tol=1e-3)
case("unique_consecutive", lambda P, T: P.unique_consecutive(
    T(np.array([1., 1., 2., 2., 3., 1.], np.float32), grad=False)))
case("crop", lambda P, T: P.crop(T(f32(4, 6)), shape=[2, 3],
                                 offsets=[1, 2]))
case("is_empty_r3", lambda P, T: P.is_empty(T(np.zeros((0, 3),
                                                       np.float32))))
case("shard_index", lambda P, T: P.shard_index(
    T(np.array([[1], [6], [11]], np.int32)), index_num=12, nshards=2,
    shard_id=0))
case("view", lambda P, T: P.view(T(f32(4, 6)), [2, 12]))
case("as_complex_as_real", lambda P, T: (
    P.as_real(P.as_complex(T(f32(4, 3, 2), grad=False))),
    P.as_real(T(CPLX, grad=False))))
case("complex", lambda P, T: P.as_real(P.complex(T(A23, grad=False),
                                                 T(A23 * 2, grad=False))))
case("atleast", lambda P, T: (P.atleast_1d(T(np.float32(3.0))),
                              P.atleast_2d(T(V6)), P.atleast_3d(T(A23))))
case("tensor_unfold", lambda P, T: P.unfold(T(V6), 0, 3, 1))
case("scatter_overwrite", lambda P, T: P.scatter(
    T(f32(4, 6)), T(ints(1, 3)), T(np.zeros((2, 6), np.float32))))
case("scatter_add", lambda P, T: P.scatter(
    T(f32(4, 6)), T(ints(1, 3)), T(f32(2, 6)), overwrite=False))
case("scatter_nd", lambda P, T: P.scatter_nd(
    T(np.array([[1], [3]], np.int32)), T(np.ones((2, 6), np.float32)),
    [4, 6]))
case("scatter_nd_add", lambda P, T: P.scatter_nd_add(
    T(f32(4, 6)), T(np.array([[1], [1]], np.int32)),
    T(np.ones((2, 6), np.float32))))
case("index_put", lambda P, T: P.index_put(
    T(f32(4, 6)), (T(ints(0, 2)), T(ints(1, 3))),
    T(np.array([9., 8.], np.float32))))
case("einsum_op", lambda P, T: P.einsum("ij,jk->ik", T(A23), T(B34)))

# ---------------------------------------------------------------------------
# the rest of the slice's OPS table
# ---------------------------------------------------------------------------
case("zeros_ones_full_like", lambda P, T: (
    P.zeros_like(T(A23)), P.ones_like(T(I34)), P.full_like(T(A23), 2.5),
    P.empty_like(T(A23)) * 0, P.zeros_like(T(A23), dtype="int32")))
case("assign_clone", lambda P, T: (P.assign(T(A23)) * 2,
                                   P.clone(T(A23)) * 3, T(A23).clone()))
case("tril_triu", lambda P, T: (P.tril(T(A45), 1), P.triu(T(A45), -1)))
case("diag", lambda P, T: (P.diag(T(V6)), P.diag(T(A45), 1),
                           P.diag(T(V6), padding_value=2.0)))
case("creation", lambda P, T: (
    P.zeros([2, 3]), P.ones([3], "int32"), P.full([2, 2], 1.5),
    P.full([2], 3), P.eye(3, 4), P.arange(5), P.arange(1.0, 3.0, 0.5),
    P.linspace(0.0, 1.0, 5), P.logspace(0.0, 2.0, 3), P.empty([2]) * 0,
    P.tril_indices(3, 3), P.triu_indices(3, 4, 1),
    P.meshgrid(T(V6[:3]), T(V8[:2]))),
     # the reference's meshgrid and broadcast_tensors record nothing
     grad=False)
case("flatten", lambda P, T: (P.flatten(T(A345), 1),
                              P.flatten(T(A345), 0, 1)))
case("broadcast_to", lambda P, T: P.broadcast_to(T(V6[:4]), [3, 4]))
case("broadcast_tensors", lambda P, T: P.broadcast_tensors(
    [T(V6[:4]), T(f32(3, 1))]), grad=False)
case("roll_flip_rot90", lambda P, T: (
    P.roll(T(A34), 1, axis=1), P.roll(T(A34), -2), P.flip(T(A34), [0]),
    P.rot90(T(A34))))
case("slice", lambda P, T: P.slice(T(A345), [0, 2], [1, 1], [3, 4]))
case("moveaxis_swapaxes", lambda P, T: (
    P.moveaxis(T(A345), 0, 2), P.swapaxes(T(A345), 0, 1)))
case("as_strided", lambda P, T: P.as_strided(T(A34), [2, 2], [4, 1], 1))
case("tensordot", lambda P, T: P.tensordot(T(A345), T(f32(4, 5, 2)), 2))
case("unstack", lambda P, T: P.unstack(T(A345), axis=1))
case("fill_diagonal", lambda P, T: P.fill_diagonal(T(A45), 0.5, 1))
case("expand_shape", lambda P, T: P.expand(T(A34), [2, 3, 4]))
case("t", lambda P, T: (P.t(T(A34)), T(A34).t()))
case("mm_bmm", lambda P, T: (P.mm(T(A34), T(A45)),
                             P.bmm(T(f32(2, 3, 4)), T(f32(2, 4, 2)))))
case("dot_inner_outer", lambda P, T: (
    P.dot(T(V8), T(V8[::-1].copy())), P.inner(T(A34), T(B34)),
    P.outer(T(V6), T(V8))))
case("addmm_mv", lambda P, T: (P.addmm(T(f32(3, 5)), T(A34), T(A45),
                                       0.5, 2.0),
                               P.mv(T(A34), T(V6[:4]))))
case("cross", lambda P, T: P.cross(T(f32(4, 3)), T(f32(4, 3))))
case("inverse_det", lambda P, T: (P.inverse(T(SQ)), P.det(T(SQ)),
                                  P.slogdet(T(SQ))), tol=1e-4,
     grad_tol=1e-3)
case("lstsq", lambda P, T: P.lstsq(T(f32(4, 3)), T(f32(4, 2)))[0],
     tol=1e-4, grad=False)


def _qr(P, T):
    q, r = P.qr(T(A34.T.copy()))
    return P.matmul(q, r), P.abs(r)


def _svd(P, T):
    u, s, vh = P.svd(T(A34))
    return P.matmul(u * s.unsqueeze(0), vh), s


def _eigh(P, T):
    w, v = P.eigh(T(SYM))
    return w, P.matmul(P.matmul(v, P.diag(w)), P.t(v)), P.eigvalsh(T(SYM))


def _eig(P, T):
    w, v = P.eig(T(SQ, grad=False))
    wr = P.sort(P.real(w))
    return wr, P.sort(P.real(P.eigvals(T(SQ, grad=False))))


def _lu(P, T):
    lu, piv = P.lu(T(SQ))
    p, low, up = P.lu_unpack(lu, piv)
    return P.matmul(P.matmul(p, low), up), lu


case("qr", _qr, tol=1e-4, grad=False)
case("svd", _svd, tol=1e-4, grad=False)
case("eigh", _eigh, tol=1e-4, grad=False)
case("eig", _eig, tol=1e-4, grad=False)
case("lu", _lu, tol=1e-4, grad=False)
case("kron", lambda P, T: P.kron(T(A23), T(f32(2, 2))))
case("trace_diagonal", lambda P, T: (P.trace(T(A45)),
                                     P.diagonal(T(A345), 1, 1, 2)))
case("householder_product", lambda P, T: P.householder_product(
    T(f32(4, 3)), T(f32(3))), tol=1e-4, grad=False)
case("p_norm", lambda P, T: (P.p_norm(T(A34), 3.0, axis=1),
                             P.p_norm(T(A34), float("inf"), asvector=True)))
case("spectral_norm", lambda P, T: P.spectral_norm(T(A34), power_iters=3),
     tol=1e-4, grad_tol=1e-3)

# ---------------------------------------------------------------------------
# the nn ops (ops/nn_ops.py's in-slice names)
# ---------------------------------------------------------------------------
case("linear", lambda P, T: P.nn.functional.linear(T(A34), T(A45),
                                                   T(V6[:5])))
case("embedding", lambda P, T: P.nn.functional.embedding(
    T(np.array([[0, 3], [2, 2]], np.int32)), T(f32(5, 4))))
case("layer_norm", lambda P, T: P.nn.functional.layer_norm(
    T(A345), T(pos(5)), T(f32(5))), tol=1e-5)
case("rms_norm", lambda P, T: P.nn.functional.rms_norm(T(A345), T(pos(5))))
case("activations", lambda P, T: (
    P.nn.functional.gelu(T(A34)),
    P.nn.functional.gelu(T(A34), approximate=True),
    P.nn.functional.relu(T(A34)), P.nn.functional.silu(T(A34)),
    P.nn.functional.tanh(T(A34))), tol=1e-5)
case("dropout_eval", lambda P, T: (
    P.nn.functional.dropout(T(A34), 0.5, training=False),
    P.nn.functional.dropout(T(A34), 0.0)))
case("cross_entropy", lambda P, T: (
    P.nn.functional.cross_entropy(T(A34), T(ints(0, 3, 1))),
    P.nn.functional.cross_entropy(T(A34), T(ints(0, 3, 1)),
                                  reduction="none", label_smoothing=0.1)),
     tol=1e-5)
case("sdpa", lambda P, T: P.nn.functional.scaled_dot_product_attention(
    T(QKV), T(QKV[::-1].copy()), T(QKV * 0.5), is_causal=True), tol=1e-4,
     grad_tol=1e-4)
case("sdpa_mask", lambda P, T: P.nn.functional.scaled_dot_product_attention(
    T(f32(2, 5, 2, 8)), T(f32(2, 7, 2, 8)), T(f32(2, 7, 2, 8)),
    attn_mask=T(f32(5, 7) > -0.4, grad=False)), tol=1e-5)
case("conv1d", lambda P, T: P.nn.functional.conv1d(
    T(SEQ), T(f32(6, 4, 3)), T(V6), padding=1), tol=1e-4, grad_tol=1e-4)
case("conv2d", lambda P, T: P.nn.functional.conv2d(
    T(IMG), T(f32(6, 4, 3, 3)), T(V6), stride=2, padding=1), tol=1e-4,
     grad_tol=1e-4)
case("conv2d_nhwc", lambda P, T: P.nn.functional.conv2d(
    T(IMG.transpose(0, 2, 3, 1).copy()), T(f32(6, 2, 3, 3)), None,
    padding="SAME", groups=2, data_format="NHWC"), tol=1e-4,
     grad_tol=1e-4)
case("conv3d", lambda P, T: P.nn.functional.conv3d(
    T(IMG3), T(f32(2, 3, 2, 2, 2)), padding=1), tol=1e-4, grad_tol=1e-4)
case("conv2d_transpose", lambda P, T: P.nn.functional.conv2d_transpose(
    T(IMG), T(f32(4, 3, 3, 3)), T(V6[:3]), stride=2, padding=1),
     tol=1e-4, grad_tol=1e-4)
case("conv3d_transpose", lambda P, T: P.nn.functional.conv3d_transpose(
    T(IMG3), T(f32(3, 2, 2, 2, 2)), stride=2), tol=1e-4, grad_tol=1e-4)
case("pools", lambda P, T: (
    P.nn.functional.max_pool1d(T(SEQ), 4, 2, 0),
    P.nn.functional.avg_pool1d(T(SEQ), 4, 2, 0),
    P.nn.functional.max_pool2d(T(IMG), 3, 2, 1),
    P.nn.functional.avg_pool2d(T(IMG), 2, 2, 0),
    P.nn.functional.max_pool3d(T(IMG3), 2, 2, 0),
    P.nn.functional.avg_pool3d(T(IMG3), 2, 2, 0)), tol=1e-5)
case("adaptive_pools", lambda P, T: (
    P.nn.functional.adaptive_avg_pool1d(T(SEQ), 4),
    P.nn.functional.adaptive_avg_pool2d(T(IMG), 3),
    P.nn.functional.adaptive_max_pool2d(T(IMG), 3),
    P.nn.functional.adaptive_avg_pool3d(T(IMG3), 2)), tol=1e-5)

case("flash_attention", lambda P, T: _flash_attention(P, T), tol=1e-4,
     grad_tol=1e-4)
case("embedding_padding_idx", lambda P, T: (
    P.nn.functional.embedding(T(ints(0, 1, 0)), T(np.ones((3, 2),
                                                         np.float32)),
                              padding_idx=0),
    P.nn.functional.embedding(x=T(np.array([[0, 3], [2, 2]], np.int32)),
                              weight=T(f32(5, 4)), padding_idx=2)))
case("layer_norm_normalized_shape", lambda P, T: (
    P.nn.functional.layer_norm(T(A345), T(pos(4, 5)), T(f32(4, 5)),
                               normalized_shape=[4, 5]),
    P.nn.functional.layer_norm(T(A345), begin_norm_axis=1)), tol=1e-5)


def _flash_attention(P, T):
    """The reference's API returns (out, None)."""
    out, softmax = P.nn.functional.flash_attention(
        T(QKV), T(QKV[::-1].copy()), T(QKV * 0.5), causal=True)
    assert softmax is None
    return out


# ---------------------------------------------------------------------------
# inputs the port once refused or answered otherwise (ROADMAP Queue C)
# ---------------------------------------------------------------------------
BOOL3 = np.array([True, False, True])
case("t_rank3", lambda P, T: (P.t(T(A345)), T(A345).t()))
case("clip_no_bounds", lambda P, T: P.clip(T(A34)))
case("scalar_outer_inner_kron", lambda P, T: (
    P.outer(T(V8), 2.0), P.inner(T(V8), 2.0), P.kron(T(A23), 2.0)))
case("heaviside_int", lambda P, T: P.heaviside(T(I34), T(J34 - 4)))
case("bool_with_int", lambda P, T: [
    getattr(P, op)(T(BOOL3), 2) for op in (
        "maximum", "minimum", "fmax", "fmin", "bitwise_and", "bitwise_or",
        "bitwise_xor", "subtract")])
case("bool_unary", lambda P, T: [
    P.abs(T(BOOL3)), P.floor(T(BOOL3)), P.ceil(T(BOOL3)),
    P.trunc(T(BOOL3)), P.argmax(T(BOOL3)), P.argmin(T(BOOL3)),
    P.nn.functional.relu(T(BOOL3))])
case("lstsq_underdetermined", lambda P, T: P.lstsq(T(A34), T(B34))[:2],
     tol=1e-4, grad=False)
# an empty axis list reduces no axis, as jnp reduces none
case("reduce_no_axes", lambda P, T: [
    getattr(P, op)(T(A34), axis=[]) for op in (
        "sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
        "nansum", "nanmean", "median")] + [
    P.sum(T(I34), axis=[]), P.all(T(BOOL34), axis=[]),
    P.any(T(I34), axis=[]), P.count_nonzero(T(A34), axis=[])])
case("var_std_no_axes", lambda P, T: [
    P.var(T(A34), axis=[]), P.std(T(A34), axis=[]),
    P.var(T(A34), axis=[], unbiased=False)], grad=False)
case("instance_norm_2d", lambda P, T: P.nn.functional.instance_norm(
    T(A34), T(pos(4)), T(f32(4))), tol=1e-5)
case("bincount_int_weights", lambda P, T: P.bincount(
    T(ints(0, 1, 1, 3)), weights=T(ints(2, 3, 4, 5))), grad=False)
case("digamma_at_zero", lambda P, T: P.digamma(T(np.array(
    [0.0, -0.0, -1.0, 1.0, 2.5], np.float32))), tol=1e-5, grad=False)


def _batch_norm(P, T):
    x = T(IMG)
    rm, rv = T(f32(4), grad=False), T(pos(4), grad=False)
    out, m, v = P.nn.functional.batch_norm(x, rm, rv, T(pos(4)), T(f32(4)),
                                           training=True)
    ev = P.nn.functional.batch_norm(x, rm, rv, training=False)
    # the new running statistics are compared as values only
    return out, m.detach(), v.detach(), ev[0]


case("batch_norm", _batch_norm, tol=1e-5, grad_tol=1e-4)


# ---------------------------------------------------------------------------
# the rest of the nn surface: the other nn ops, nn.functional's own,
# the recurrences, nn.quant (NN_CASES names them for chip_smoke.py's
# phase 26)
# ---------------------------------------------------------------------------
_NN_FIRST = len(CASES)


def _fn(P, name):
    return getattr(P.nn.functional, name)


for _op in ("relu6", "mish", "hardswish", "hardsigmoid", "tanhshrink",
            "softsign", "selu"):
    case(_op, lambda P, T, op=_op: _fn(P, op)(T(A34 * 4)), tol=1e-5)
case("act_params", lambda P, T: (
    P.nn.functional.leaky_relu(T(A34), 0.2),
    P.nn.functional.elu(T(A34 * 3), 0.7),
    P.nn.functional.celu(T(A34 * 3), 1.5),
    P.nn.functional.hardtanh(T(A34 * 3), -0.5, 0.8),
    P.nn.functional.hardshrink(T(A34), 0.3),
    P.nn.functional.softshrink(T(A34), 0.3),
    P.nn.functional.softplus(T(A34 * 30), 2.0, 20.0),
    P.nn.functional.thresholded_relu(T(A34), 0.2, 0.5),
    P.nn.functional.swish(T(A34))), tol=1e-5)
case("prelu", lambda P, T: (
    P.nn.functional.prelu(T(IMG), T(pos(4))),
    P.nn.functional.prelu(T(IMG.transpose(0, 2, 3, 1).copy()), T(pos(4)),
                          data_format="NHWC"),
    P.nn.functional.prelu(T(A34), T(np.array([0.25], np.float32)))))
case("maxout_glu", lambda P, T: (
    P.nn.functional.maxout(T(IMG), 2), P.nn.functional.maxout(
        T(IMG.transpose(0, 2, 3, 1).copy()), 2, axis=-1),
    P.nn.functional.glu(T(A34)), P.nn.functional.glu(T(IMG), axis=1)),
     tol=1e-5)
case("softmax_family", lambda P, T: (
    P.nn.functional.softmax(T(A345), 1),
    P.nn.functional.log_softmax(T(A345)),
    P.nn.functional.softmax_(T(A34), 0)), tol=1e-5)
# the draws differ by design: the rows of a sample sum to 1, and the hard
# sample is one-hot
case("gumbel_softmax", lambda P, T: (
    P.sum(P.nn.functional.gumbel_softmax(T(A34), 0.5), -1),
    P.sum(P.nn.functional.gumbel_softmax(T(A34), hard=True), -1),
    P.max(P.nn.functional.gumbel_softmax(T(A34), hard=True), -1)),
     tol=1e-5, grad=False)
case("dropouts_eval", lambda P, T: (
    P.nn.functional.dropout2d(T(IMG), 0.5, training=False),
    P.nn.functional.alpha_dropout(T(A34), 0.5, training=False),
    P.nn.functional.rrelu(T(A34), training=False)))
case("one_hot", lambda P, T: P.nn.functional.one_hot(
    T(np.array([[0, 3], [2, 5], [-1, 1]], np.int32)), 4))
case("group_instance_norm", lambda P, T: (
    P.nn.functional.group_norm(T(IMG), 2, T(pos(4)), T(f32(4))),
    P.nn.functional.group_norm(T(IMG.transpose(0, 2, 3, 1).copy()), 4,
                               data_format="NHWC"),
    P.nn.functional.instance_norm(T(IMG), T(pos(4)), T(f32(4))),
    P.nn.functional.instance_norm(T(SEQ))), tol=1e-5, grad_tol=1e-4)
case("local_response_norm", lambda P, T: P.nn.functional.local_response_norm(
    T(IMG), 3, 1e-2, 0.75, 2.0), tol=1e-5)
case("regression_losses", lambda P, T: [
    getattr(P.nn.functional, op)(T(A34), T(B34), reduction=r)
    for op in ("mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss")
    for r in ("mean", "sum", "none")], tol=1e-5)
case("classification_losses", lambda P, T: (
    P.nn.functional.softmax_with_cross_entropy(
        T(A34), T(ints(0, 3, 1)[:, None])),
    P.nn.functional.softmax_with_cross_entropy(
        T(A34), T(ints(0, -100, 1)[:, None]), return_softmax=True),
    P.nn.functional.softmax_with_cross_entropy(
        T(A34), T(np.full((3, 4), 0.25, np.float32), grad=False),
        soft_label=True),
    P.nn.functional.nll_loss(T(A34), T(ints(0, 3, 1))),
    P.nn.functional.nll_loss(T(A34), T(ints(0, -100, 1)), T(pos(4)),
                             reduction="none"),
    P.nn.functional.nll_loss(T(A34), T(ints(0, 2, 1)), T(pos(4)))),
     tol=1e-5)
case("binary_losses", lambda P, T: (
    P.nn.functional.binary_cross_entropy(T(U34 * 0.5 + 0.5), T(P34 / 2)),
    P.nn.functional.bce_loss(T(U34 * 0.5 + 0.5), T(P34 / 2), T(pos(4)),
                             reduction="none"),
    P.nn.functional.binary_cross_entropy_with_logits(T(A34 * 3),
                                                     T(P34 / 2)),
    P.nn.functional.binary_cross_entropy_with_logits(
        T(A34 * 3), T(P34 / 2), pos_weight=T(pos(4)), reduction="sum"),
    P.nn.functional.sigmoid_cross_entropy_with_logits(
        T(A34 * 3), T(np.where(A34 > 0.5, -100.0, P34 / 2).astype(
            np.float32), grad=False), normalize=True),
    P.nn.functional.log_loss(T(U34 * 0.5 + 0.5), T(P34 / 2))), tol=1e-5,
     grad_tol=1e-4)
case("kl_div", lambda P, T: (
    P.nn.functional.kl_div(T(A34), T(P34 / 2)),
    P.nn.functional.kl_div(T(A34), T(A34 * 0.5), "batchmean", True),
    P.nn.functional.kl_div(T(A34), T(P34 / 2), "none")), tol=1e-5)
case("ranking_losses", lambda P, T: (
    P.nn.functional.margin_ranking_loss(
        T(V8), T(V8[::-1].copy()), T(np.sign(f32(8)), grad=False), 0.1),
    P.nn.functional.hinge_embedding_loss(
        T(A34), T(np.where(B34 > 0, 1.0, -1.0).astype(np.float32),
                  grad=False), 0.5, "sum"),
    P.nn.functional.cosine_embedding_loss(
        T(A34), T(B34), T(ints(1, -1, 1), grad=False), 0.1),
    P.nn.functional.triplet_margin_loss(T(A34), T(B34), T(P34), swap=True),
    P.nn.functional.triplet_margin_loss(T(A34), T(B34), T(P34), p=1.0,
                                        reduction="none"),
    P.nn.functional.square_error_cost(T(A34), T(B34))), tol=1e-5,
     grad_tol=1e-4)
case("label_smooth_npair", lambda P, T: (
    P.nn.functional.label_smooth(T(P34 / 2)),
    P.nn.functional.label_smooth(T(P34 / 2), T(np.full((1, 4), 0.25,
                                                       np.float32)), 0.2),
    P.nn.functional.npair_loss(T(A34), T(B34), T(ints(0, 1, 2)))),
     tol=1e-5)
case("hsigmoid_loss", lambda P, T: (
    P.nn.functional.hsigmoid_loss(T(A34), T(ints(0, 4, 2)), 6,
                                  T(f32(5, 4)), T(f32(5))),
    P.nn.functional.hsigmoid_loss(
        T(A34), T(ints(0, 1, 2)), 6, T(f32(5, 4)),
        path_table=T(np.array([[0, 1, -1], [0, 2, 4], [1, -1, -1]],
                              np.int32)),
        path_code=T(np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]],
                             np.int32)))), tol=1e-5)
case("margin_cross_entropy", lambda P, T:
     P.nn.functional.margin_cross_entropy(
         T(U34), T(ints(0, 3, 1)), 1.0, 0.3, 0.1, 8.0, return_softmax=True),
     tol=1e-5, grad_tol=1e-4)
case("bilinear", lambda P, T: P.nn.functional.bilinear(
    T(A34), T(B34[:, :3]), T(f32(5, 4, 3)), T(f32(5))), tol=1e-5)
case("shuffles", lambda P, T: (
    P.nn.functional.pixel_shuffle(T(IMG), 2),
    P.nn.functional.pixel_shuffle(T(IMG.transpose(0, 2, 3, 1).copy()), 2,
                                  "NHWC"),
    P.nn.functional.pixel_unshuffle(T(IMG), 2),
    P.nn.functional.channel_shuffle(T(IMG), 2)))
case("interpolate", lambda P, T: (
    P.nn.functional.interpolate(T(IMG), size=[12, 5], mode="bilinear"),
    P.nn.functional.interpolate(T(IMG), scale_factor=0.5, mode="bicubic"),
    P.nn.functional.interpolate(T(IMG), size=[5, 11], mode="nearest"),
    P.nn.functional.upsample(T(IMG), scale_factor=1.5, mode="bilinear",
                             align_corners=True)), tol=1e-5)
case("unfold_fold", lambda P, T: (
    P.nn.functional.unfold(T(IMG), 3, 2, 1, 1),
    P.nn.functional.fold(T(f32(2, 12, 9)), (4, 4), 2, 1)), tol=1e-5)
case("temporal_shift_affine_grid", lambda P, T: (
    P.nn.functional.temporal_shift(T(f32(4, 8, 3, 3)), 2, 0.25),
    P.nn.functional.affine_grid(T(f32(2, 2, 3)), [2, 3, 5, 4]),
    P.nn.functional.affine_grid(T(f32(2, 2, 3)), [2, 3, 4, 6],
                                align_corners=False)), tol=1e-5)
case("grid_sample", lambda P, T: (
    P.nn.functional.grid_sample(T(IMG), T(U34.reshape(1, 3, 2, 2).repeat(
        2, 0) * 1.2)),
    P.nn.functional.grid_sample(T(IMG), T(f32(2, 3, 4, 2)),
                                align_corners=False, padding_mode="border"),
    P.nn.functional.grid_sample(T(IMG), T(f32(2, 3, 4, 2)),
                                mode="nearest")), tol=1e-5, grad_tol=1e-4)
case("adaptive_max_pools", lambda P, T: (
    P.nn.functional.adaptive_max_pool1d(T(SEQ), 5),
    P.nn.functional.adaptive_max_pool1d(T(SEQ), 4, return_mask=True),
    P.nn.functional.adaptive_max_pool3d(T(IMG3), (2, 3, 4)),
    P.nn.functional.adaptive_max_pool3d(T(IMG3), 2, return_mask=True)))
case("unpool", lambda P, T: P.nn.functional.unpool(
    T(f32(2, 3, 2, 2)), T(np.array([0, 3, 9, 14] * 6, np.int32).reshape(
        2, 3, 2, 2)), 2))
case("cosine_similarity_normalize", lambda P, T: (
    P.nn.functional.cosine_similarity(T(A34), T(B34)),
    P.nn.functional.cosine_similarity(T(A34), T(B34), axis=-1),
    P.nn.functional.normalize(T(A34)),
    P.nn.functional.normalize(T(A345), 1.0, axis=-1)), tol=1e-5)
case("sequence_mask", lambda P, T: P.nn.functional.sequence_mask(
    T(ints(1, 3, 0)), maxlen=4))


def _unpadded(P, T):
    """flash_attn_unpadded on 3 sequences packed into 128 rows, 18 of
    them padding: the padding's outputs are 0."""
    q, k, v = (T(f32(128, 2, 64)) for _ in range(3))
    cu = T(ints(0, 50, 90, 110), grad=False)
    out, soft = P.nn.functional.flash_attn_unpadded(q, k, v, cu, cu, 50, 50)
    assert soft is None
    return out


case("flash_attn_unpadded", _unpadded, tol=1e-4, grad_tol=1e-4)


def _rnnt(P, T):
    logits = T(f32(2, 4, 3, 5) * 2)
    labels = T(np.array([[1, 2], [3, 0]], np.int32))
    t_len, u_len = T(ints(4, 3)), T(ints(2, 1))
    return (P.ops.rnnt_loss_op(logits, labels, t_len, u_len),
            P.nn.functional.rnnt_loss(logits, labels, t_len, u_len,
                                      reduction="sum"))


case("rnnt_loss", _rnnt, tol=1e-5, grad_tol=1e-4)


def _scans(P, T):
    rnn = P.nn.layers.rnn
    x, h0, c0 = T(f32(4, 2, 3)), T(f32(2, 5)), T(f32(2, 5))
    lstm = [T(f32(20, 3)), T(f32(20, 5)), T(f32(20)), T(f32(20))]
    gru = [T(f32(15, 3)), T(f32(15, 5)), T(f32(15)), T(f32(15))]
    srnn = [T(f32(5, 3)), T(f32(5, 5)), T(f32(5)), T(f32(5))]
    return (rnn._lstm_scan(x, h0, c0, *lstm),
            rnn._lstm_scan(x, h0, c0, *lstm, reverse=True),
            rnn._gru_scan(x, h0, *gru, reverse=True),
            rnn._rnn_scan(x, h0, *srnn),
            rnn._rnn_scan(x, h0, *srnn, activation="relu", reverse=True))


case("rnn_scans", _scans, tol=1e-5, grad_tol=1e-4)


def _quant(P, T):
    q = P.nn.quant
    w = T(f32(8, 6) * 3)
    codes8, s8 = q.weight_quantize(w)
    codes4, s4 = q.weight_quantize(w, algo="weight_only_int4")
    x = T(A45[:3, :4].repeat(2, 1))
    xo = T(np.where(np.arange(8) == 2, A45[:3, :1] * 20, 1.0).astype(
        np.float32) * f32(3, 8))
    return (codes8, s8, codes4, s4,
            q.weight_dequantize(codes8, s8, out_dtype="float32"),
            q.weight_dequantize(codes4, s4, "weight_only_int4", "float32"),
            q.weight_only_linear(x, codes8, T(f32(6)), s8),
            q.weight_only_linear(x, codes4, None, s4, "int4"),
            q.llm_int8_linear(xo, codes8, T(f32(6)), s8, threshold=6.0))


case("quant", _quant, tol=1e-5, grad_tol=1e-4)
NN_CASES = [c[0] for c in CASES[_NN_FIRST:]]


# ---------------------------------------------------------------------------
# the long-tail ops, sequence ops and vision / detection ops (ops/longtail,
# ops/sequence_ops, ops/vision_ops, vision/ops)
# ---------------------------------------------------------------------------
_LT_FIRST = len(CASES)


def _split_pieces(P, T):
    x = T(A345, grad=False)
    return (P.ops.tensor_split(x, 2), P.ops.tensor_split(x, [1, 3], axis=1),
            P.ops.hsplit(x, 2), P.ops.vsplit(x, [1]), P.ops.dsplit(x, 5))


case("tensor_splits", _split_pieces, grad=False)
case("stacks", lambda P, T: (
    P.ops.column_stack([T(V6), T(V6[::-1].copy())]),
    P.ops.column_stack([T(A23.T.copy()), T(V6[:3])]),
    P.ops.row_stack([T(A34), T(B34)]), P.ops.hstack([T(A34), T(B34)]),
    P.ops.vstack([T(V6), T(V6)]), P.ops.dstack([T(A34), T(B34)])))
case("unflatten", lambda P, T: (P.ops.unflatten(T(A345), 2, [5, 1]),
                                P.ops.unflatten(T(A345), -2, [2, -1])))
case("take", lambda P, T: (
    P.ops.take(T(A34), T(ints(0, 11, -1, 5))),
    P.ops.take(T(A34), T(ints(13, -15, 2)), mode="wrap"),
    P.ops.take(T(A34), T(ints(30, -20, 4)), mode="clip")))
case("block_diag_cartesian_combinations", lambda P, T: (
    P.ops.block_diag([T(A23), T(V6[:2]), T(SQ[:3, :3])]),
    P.ops.cartesian_prod([T(V6[:3]), T(V8[:2]), T(V6[3:5])]),
    P.ops.combinations(T(V6[:4])),
    P.ops.combinations(T(V6[:3]), r=3, with_replacement=True)))
case("scatters", lambda P, T: (
    P.ops.diagonal_scatter(T(A34), T(V6[:3])),
    P.ops.diagonal_scatter(T(A34), T(V6[:3]), offset=1),
    P.ops.diagonal_scatter(T(A345), T(f32(5, 2)), offset=-1, axis1=0,
                           axis2=1),
    P.ops.select_scatter(T(A345), T(f32(3, 5)), 1, 2),
    P.ops.slice_scatter(T(A345), T(f32(3, 2, 2)), [1, 2], [0, 1], [4, 5],
                        [2, 2]),
    P.ops.fill_diagonal_tensor(T(A34), T(V6[:3]), offset=1)))
case("reverse", lambda P, T: (P.ops.reverse(T(A345), 1),
                              P.ops.reverse(T(A345), [0, 2])))
case("sinc_sign_tests", lambda P, T: (
    P.ops.sinc(T(A34 * 3)), P.ops.signbit(T(A34, grad=False)),
    P.ops.isposinf(T(np.array([1, np.inf, -np.inf], np.float32),
                     grad=False)),
    P.ops.isneginf(T(np.array([1, np.inf, -np.inf], np.float32),
                     grad=False)),
    P.ops.isreal(T(CPLX, grad=False)), P.ops.isreal(T(A23, grad=False)),
    P.ops.positive(T(A23)), P.ops.negative(T(A23)), P.ops.sgn(T(A34)),
    P.ops.sgn(T(np.array([0, 3 + 4j, -2j], np.complex64), grad=False))))
case("float_power_vander", lambda P, T: (
    P.ops.float_power(T(P34), T(A34)), P.ops.float_power(T(P34), 2.5),
    P.ops.vander(T(V6[:4])), P.ops.vander(T(V6[:3]), n=5,
                                          increasing=True)), tol=1e-5)
case("gamma_functions", lambda P, T: (
    P.ops.gammaln(T(P34 * 3)), P.ops.gammainc(T(P34 * 2), T(P34)),
    P.ops.gammaincc(T(P34 + 1), T(P34 * 2)),
    P.ops.multigammaln(T(P34 + 2), 3)), tol=1e-5, grad_tol=1e-4)
case("histograms", lambda P, T: (
    P.ops.histogram_bin_edges(T(V8, grad=False), bins=5),
    P.ops.histogram_bin_edges(T(V8, grad=False), bins=4, min=-2, max=2),
    P.ops.histogramdd(T(f32(20, 2), grad=False), bins=3),
    P.ops.histogramdd(T(f32(20, 3), grad=False), bins=[2, 3, 4],
                      ranges=[(-1, 1), (-0.5, 0.5), (0, 1)],
                      weights=T(pos(20), grad=False)),
    P.ops.histogramdd(T(f32(30, 2), grad=False), bins=4, density=True)),
    grad=False, tol=1e-5)
case("distances", lambda P, T: (
    P.ops.pdist(T(A45)), P.ops.pdist(T(A45), p=1.0),
    P.ops.pdist(T(A45), p=float("inf")), P.ops.pdist(T(A45), p=3.0),
    P.ops.cdist(T(A34), T(B34[:2])),
    P.ops.cdist(T(f32(2, 3, 4)), T(f32(2, 5, 4)), p=1.0),
    P.ops.cdist(T(A34), T(B34), compute_mode="donot_use_mm_for_euclid_dist"),
    P.ops.cdist(T(A34), T(B34), p=0.0)), tol=1e-5, grad_tol=1e-4)
case("complex_views", lambda P, T: (
    P.ops.polar(T(P34), T(A34)),
    P.ops.view_as_real(P.ops.view_as_complex(T(f32(3, 2)))),
    P.ops.view_as_real(T(CPLX, grad=False))))
case("linalg_tail", lambda P, T: (
    P.ops.cond(T(SQ)), P.ops.cond(T(SQ), p="fro"), P.ops.cond(T(SQ), p=1),
    P.ops.cond(T(SQ), p=-2), P.ops.matrix_exp(T(A34[:3, :3])),
    P.ops.addbmm(T(A34), T(f32(2, 3, 5)), T(f32(2, 5, 4)), beta=0.5,
                 alpha=2.0),
    P.ops.baddbmm(T(f32(2, 3, 4)), T(f32(2, 3, 5)), T(f32(2, 5, 4)),
                  beta=1.5),
    P.ops.cholesky_inverse(T(TRIL)),
    P.ops.cholesky_inverse(T(TRIL.T.copy()), upper=True)),
    tol=1e-4, grad_tol=1e-4)
case("geqrf_orgqr", lambda P, T: (
    P.ops.geqrf(T(f32(5, 3), grad=False)),
    P.ops.geqrf(T(f32(2, 4, 4), grad=False)),
    P.ops.orgqr(*P.ops.geqrf(T(f32(5, 3), grad=False)))), tol=1e-4,
    grad=False)
case("yaml_misc", lambda P, T: (
    P.ops.mean_all(T(A345)), P.ops.check_numerics(T(A34)),
    P.ops.index_select_strided(T(A345), T(ints(2, 0)), axis=2),
    P.ops.trans_layout(T(A345), [2, 0, 1]),
    P.ops.squared_l2_norm(T(A34)),
    P.ops.frexp(T(np.array([0.0, 1.0, -3.5, 1e-3, 6e4, -0.75],
                           np.float32)))))
# outputs that are constant in the inputs' values (counts, shapes, fills,
# the metrics): the reference records them (a zero gradient), the port
# does not (no gradient)
case("yaml_constants", lambda P, T: (
    P.ops.accuracy_op(T(f32(6, 5)), T(ints(0, 1, 2, 3, 4, 0)), k=2),
    P.ops.auc_op(T(pos(10, 2)), T(ints(0, 1, 1, 0, 1, 0, 0, 1, 1, 0))),
    P.ops.numel(T(A345)), P.ops.shape_op(T(A345)), P.ops.fill(T(A34), 2.5),
    P.ops.view_dtype(T(A34, grad=False), "int32"),
    P.ops.assign_value([2, 3], "float32", [1, 2, 3, 4, 5, 6]),
    P.ops.full_batch_size_like(T(A345), [1, 7], 0.5, input_dim_idx=1,
                               output_dim_idx=1)), grad=False)

# sequence ops
case("ctc_loss", lambda P, T: tuple(
    P.ops.ctc_loss(T(f32(6, 2, 4) * 2), T(np.array([[1, 2], [3, 1]],
                                                    np.int32)),
                   T(ints(6, 5)), T(ints(2, 1)), reduction=r,
                   norm_by_times=n)
    for r, n in (("mean", False), ("sum", False), ("none", True))) + (
    P.nn.functional.ctc_loss(T(f32(5, 1, 3)), T(ints(1, 2)[None]),
                             T(ints(5)), T(ints(2))),), tol=1e-5,
    grad_tol=1e-4)
case("viterbi_decode", lambda P, T: (
    P.ops.viterbi_decode(T(f32(2, 5, 4)), T(f32(4, 4)), T(ints(5, 3)),
                         include_bos_eos_tag=False),
    P.ops.viterbi_decode(T(f32(2, 4, 5)), T(f32(5, 5)), T(ints(2, 4)))),
    tol=1e-5, grad=False)
case("gather_tree", lambda P, T: P.ops.gather_tree(
    T(np.array([[[2, 5, 1]], [[3, 6, 2]], [[4, 7, 3]], [[8, 9, 1]]],
               np.int32)),
    T(np.array([[[0, 0, 0]], [[1, 0, 2]], [[0, 2, 1]], [[2, 2, 0]]],
               np.int32))))
case("top_p_sampling_nucleus_of_one", lambda P, T: P.ops.top_p_sampling(
    T(np.array([[0.5, 0.3, 0.15, 0.05], [0.05, 0.1, 0.8, 0.05]],
               np.float32), grad=False),
    T(np.array([0.1, 0.5], np.float32)), seed=3), grad=False)
case("edit_distance", lambda P, T: (
    P.ops.edit_distance(T(np.array([[1, 2, 3, 0], [4, 4, 1, 2]], np.int32)),
                        T(np.array([[1, 3, 3, 4, 1], [4, 1, 2, 0, 0]],
                                   np.int32)),
                        T(ints(3, 4)), T(ints(5, 3)), normalized=False),
    P.ops.edit_distance(T(np.array([[5, 1, 2]], np.int32)),
                        T(np.array([[1, 2, 5]], np.int32)))))
case("class_center_sample_positives", lambda P, T: P.ops.class_center_sample(
    T(ints(3, 7, 3, 1)), 10, 3, seed=2), grad=False)


def _boxes(n, size, lo=2.0, hi=None):
    """n random (x1, y1, x2, y2) boxes inside [0, size]."""
    hi = size / 2 if hi is None else hi
    xy = f32(n, 2, lo=0.0, hi=size - hi)
    wh = f32(n, 2, lo=lo, hi=hi)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# vision / detection ops
case("depthwise_conv2d", lambda P, T: (
    P.ops.depthwise_conv2d(T(IMG), T(f32(4, 1, 3, 3)), padding=1),
    P.nn.functional.depthwise_conv2d(T(IMG), T(f32(8, 1, 3, 3)),
                                     T(f32(8)), stride=2)), tol=1e-5,
    grad_tol=1e-5)


def _deform(P, T, fn, groups):
    x = T(f32(1, 4, 6, 6))
    return (fn(x, T(f32(1, 18, 6, 6) * 0.7), T(f32(6, 4, 3, 3)),
               padding=1),
            fn(x, T(f32(1, 36, 4, 4) * 0.7), T(f32(6, 4 // groups, 3, 3)),
               mask=T(pos(1, 18, 4, 4) / 2), bias=T(f32(6)),
               deformable_groups=2, groups=groups))


# the reference's ops.deformable_conv takes groups=1 only (its weight
# reshape fails otherwise); vision.ops.deform_conv2d takes groups
case("deformable_conv", lambda P, T: _deform(P, T, P.ops.deformable_conv, 1),
     tol=1e-5, grad_tol=1e-4)
case("deform_conv2d", lambda P, T: _deform(P, T, P.vision.ops.deform_conv2d,
                                           2), tol=1e-5, grad_tol=1e-4)
case("max_pools_with_index", lambda P, T: (
    P.ops.max_pool2d_with_index(T(IMG), 3, 2, padding=1),
    P.nn.functional.max_pool2d_with_index(T(IMG), 2),
    P.ops.max_pool3d_with_index(T(IMG3), 2, padding=[0, 1, 1])))
case("unpool3d", lambda P, T: P.ops.unpool3d(
    *P.ops.max_pool3d_with_index(T(IMG3), 2), 2))
case("roi_pools", lambda P, T: (
    P.ops.roi_pool(T(f32(2, 3, 12, 14)),
                   T(_boxes(5, 24.0, hi=14.0), grad=False), T(ints(2, 3)),
                   output_size=3, spatial_scale=0.5),
    P.ops.roi_pool(T(IMG), T(_boxes(3, 8.0, lo=1.0, hi=5.0), grad=False),
                   output_size=(2, 4)),
    P.ops.psroi_pool(T(f32(2, 8, 10, 12)),
                     T(_boxes(4, 20.0, hi=12.0), grad=False), T(ints(1, 3)),
                     output_size=2, spatial_scale=0.5)), tol=1e-5)
case("roi_align", lambda P, T: (
    P.vision.ops.roi_align(T(f32(2, 3, 10, 12)),
                           T(_boxes(5, 20.0, hi=12.0), grad=False),
                           T(ints(2, 3)), 3, spatial_scale=0.5),
    P.vision.ops.roi_align(T(IMG), T(_boxes(2, 8.0), grad=False),
                           T(ints(1, 1)), (2, 3), aligned=False)),
    tol=1e-5, grad_tol=1e-5)
case("prior_box", lambda P, T: P.ops.prior_box(
    T(f32(1, 3, 4, 5)), T(f32(1, 3, 32, 40)), [8.0, 12.0],
    max_sizes=[16.0, 20.0], aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    grad=False)
case("yolo_box", lambda P, T: (
    P.ops.yolo_box(T(f32(2, 2 * 8, 3, 4) * 2), T(ints(64, 96, 80, 40)
                                                 .reshape(2, 2)),
                   [10, 13, 30, 20], 3, conf_thresh=0.3),
    P.ops.yolo_box(T(f32(1, 2 * 9, 3, 3) * 2), T(ints(48, 48)[None]),
                   [12, 10, 20, 30], 3, conf_thresh=0.2, clip_bbox=False,
                   scale_x_y=1.05, iou_aware=True)), tol=1e-5,
    grad_tol=1e-4)


def _nms_inputs(T, n, m, c):
    boxes = np.stack([_boxes(m, 50.0, lo=5.0, hi=25.0) for _ in range(n)])
    return T(boxes, grad=False), T(pos(n, c, m) / 2, grad=False)


case("matrix_nms", lambda P, T: (
    P.ops.matrix_nms(*_nms_inputs(T, 2, 12, 3), score_threshold=0.3,
                     nms_top_k=8, keep_top_k=10),
    P.ops.matrix_nms(*_nms_inputs(T, 1, 10, 2), score_threshold=0.2,
                     post_threshold=0.3, keep_top_k=30, use_gaussian=True,
                     normalized=False)), grad=False, tol=1e-5)
case("multiclass_nms", lambda P, T: (
    P.ops.multiclass_nms(*_nms_inputs(T, 2, 15, 3), score_threshold=0.3,
                         nms_top_k=10, keep_top_k=12, nms_threshold=0.4),
    P.ops.multiclass_nms(*_nms_inputs(T, 1, 12, 3), score_threshold=0.2,
                         keep_top_k=40, nms_threshold=0.6, normalized=False,
                         nms_eta=0.8, background_label=0)),
    grad=False, tol=1e-6)


def _proposals(P, T, pixel_offset):
    a, h, w = 3, 4, 5
    anchors = np.stack([_boxes(h * w * a, 64.0, lo=6.0, hi=24.0)]).reshape(
        h, w, a, 4)
    var = np.broadcast_to(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                          (h, w, a, 4)).copy()
    return P.ops.generate_proposals(
        T(f32(2, a, h, w), grad=False), T(f32(2, 4 * a, h, w), grad=False),
        T(np.array([[64, 60], [50, 64]], np.float32), grad=False),
        T(anchors, grad=False), T(var, grad=False), pre_nms_top_n=40,
        post_nms_top_n=12, nms_thresh=0.5, min_size=2.0,
        pixel_offset=pixel_offset)


case("generate_proposals", lambda P, T: (_proposals(P, T, False),
                                         _proposals(P, T, True)),
     grad=False, tol=1e-5)
case("distribute_fpn_proposals", lambda P, T: (
    P.ops.distribute_fpn_proposals(
        T(_boxes(12, 800.0, lo=10.0, hi=400.0), grad=False), 2, 5, 4, 224),
    P.ops.distribute_fpn_proposals(
        T(_boxes(10, 600.0, lo=8.0, hi=300.0), grad=False), 2, 4, 3, 112,
        rois_num=T(ints(4, 3)), pixel_offset=True)), grad=False)
case("nms", lambda P, T: (
    P.vision.ops.nms(T(_boxes(20, 40.0, lo=6.0, hi=16.0), grad=False), 0.4,
                     T(pos(20), grad=False)),
    P.vision.ops.nms(T(_boxes(12, 30.0, lo=6.0, hi=14.0), grad=False), 0.3,
                     top_k=5)))
case("box_coder", lambda P, T: (
    P.vision.ops.box_coder(T(_boxes(6, 40.0)), T(pos(6, 4) / 4),
                           T(_boxes(6, 40.0))),
    P.vision.ops.box_coder(T(_boxes(5, 40.0)), None, T(f32(3, 5, 4) / 2),
                           code_type="decode_center_size"),
    P.vision.ops.box_coder(T(_boxes(5, 40.0)), T(pos(5, 4) / 4),
                           T(f32(5, 4) / 2), code_type="decode_center_size")),
    tol=1e-5, grad_tol=1e-4)


def _yolo_loss(P, T):
    n, b, c, h, w = 2, 4, 3, 4, 5
    xy = f32(n, b, 2, lo=0.05, hi=0.95)
    wh = f32(n, b, 2, lo=0.05, hi=0.6)
    wh[1, 3] = 0.0                               # an empty ground truth
    gt = T(np.concatenate([xy, wh], -1), grad=False)
    label = T(np.array([[0, 2, 1, 1], [2, 0, 1, 0]], np.int32))
    x = T(f32(n, 3 * (5 + c), h, w) * 2)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    return (P.vision.ops.yolo_loss(x, gt, label, anchors, [3, 4, 5], c,
                                   0.5, 32),
            P.vision.ops.yolo_loss(x, gt, label, anchors, [0, 1, 2], c,
                                   0.3, 16, gt_score=T(pos(n, b) / 2),
                                   use_label_smooth=False))


case("yolo_loss", _yolo_loss, tol=1e-4, grad_tol=1e-4)
LONGTAIL_CASES = [c[0] for c in CASES[_LT_FIRST:]]


# ---------------------------------------------------------------------------
# incubate's registered fused ops (incubate/nn/functional), dropout off
# (INCUBATE_CASES names them for chip_smoke.py's phase 31)
# ---------------------------------------------------------------------------
_INC_FIRST = len(CASES)


def _inc(P, name):
    return getattr(P.incubate.nn.functional, name)


case("fused_rms_norm", lambda P, T: _inc(P, "fused_rms_norm")(
    T(A345), T(pos(5))), tol=1e-5)
case("fused_layer_norm", lambda P, T: _inc(P, "fused_layer_norm")(
    T(A345), T(pos(5)), T(f32(5))), tol=1e-5)


def _rotary(P, T):
    rope = _inc(P, "fused_rotary_position_embedding")
    q, k = T(f32(2, 4, 2, 8)), T(f32(2, 4, 2, 8))
    pid = T(np.array([[3, 2, 1, 0], [0, 1, 2, 3]], np.int32))
    sin, cos = T(f32(6, 8), grad=False), T(f32(6, 8), grad=False)
    return (*rope(q, k), rope(q, use_neox_rotary_style=False),
            rope(q, sin=sin, cos=cos, position_ids=pid))


case("fused_rotary_position_embedding", _rotary, tol=1e-5)
case("fused_flash_attention", lambda P, T: _inc(P, "fused_flash_attention")(
    T(QKV), T(QKV[::-1].copy()), T(QKV * 0.5), causal=True), tol=1e-4,
    grad_tol=1e-4)
case("fused_bias_dropout_residual_layer_norm", lambda P, T: _inc(
    P, "fused_bias_dropout_residual_layer_norm")(
    T(f32(2, 3, 8)), T(f32(2, 3, 8)), T(f32(8)), T(pos(8)), T(f32(8)),
    dropout_rate=0.0), tol=1e-5)
case("fused_linear", lambda P, T: (
    _inc(P, "fused_linear")(T(A34), T(A45), T(f32(5))),
    _inc(P, "fused_linear")(T(A34), T(f32(5, 4)), transpose_weight=True)),
    tol=1e-5)
case("fused_linear_activation", lambda P, T: (
    _inc(P, "fused_linear_activation")(T(A34), T(A45), T(f32(5))),
    _inc(P, "fused_linear_activation")(T(A34), T(f32(5, 4)), T(f32(5)),
                                       trans_y=True, activation="relu")),
    tol=1e-5)
case("swiglu", lambda P, T: (_inc(P, "swiglu")(T(A34), T(B34)),
                             _inc(P, "swiglu")(T(A34))), tol=1e-5)
case("fused_dropout_add", lambda P, T: (
    _inc(P, "fused_dropout_add")(T(A34), T(B34), p=0.3, training=False),
    _inc(P, "fused_dropout_add")(T(A34), T(B34), p=0.3, training=False,
                                 mode="downscale_in_infer")), tol=1e-6)
case("fused_softmax_mask", lambda P, T: _inc(P, "fused_softmax_mask")(
    T(f32(1, 2, 3, 4)), T(f32(1, 1, 3, 4))), tol=1e-5)
case("fused_softmax_mask_upper_triangle", lambda P, T: _inc(
    P, "fused_softmax_mask_upper_triangle")(T(f32(1, 2, 4, 4))), tol=1e-5)
case("fused_bias_act", lambda P, T: [
    _inc(P, "fused_bias_act")(T(A34), T(f32(4)), act_method=a)
    for a in ("gelu", "relu", "silu", "swish", "geglu", "swiglu")],
    tol=1e-5)
case("fused_matmul_bias", lambda P, T: (
    _inc(P, "fused_matmul_bias")(T(A34), T(A45), T(f32(5))),
    _inc(P, "fused_matmul_bias")(T(f32(4, 3)), T(f32(5, 4)), T(f32(5)),
                                 transpose_x=True, transpose_y=True)),
    tol=1e-5)


def _dot_product_attention(P, T):
    fdpa = _inc(P, "fused_dot_product_attention")
    q, k, v = (T(f32(2, 4, 2, 8)) for _ in range(3))
    mask = T((f32(2, 1, 4, 4) > -0.5).astype(np.int32))
    return (fdpa(q, k, v, mask=mask),
            fdpa(q, k, v, scaling_factor=0.3, is_causal_masking=True))


case("fused_dot_product_attention", _dot_product_attention, tol=1e-5)


def _ec_moe(P, T):
    moe = _inc(P, "fused_ec_moe")
    x, gate = T(f32(2, 3, 4)), T(f32(2, 3, 2))
    b0, b1 = T(f32(2, 1, 6)), T(f32(2, 1, 4))
    return (moe(x, gate, T(f32(2, 4, 6)), b0, T(f32(2, 6, 4)), b1),
            moe(x, gate, T(f32(2, 4, 6)), b0, T(f32(2, 4, 6)), b1,
                act_type="relu"))


case("fused_ec_moe", _ec_moe, tol=1e-5)


def _gate_attention(P, T):
    ga = _inc(P, "fused_gate_attention")
    q, kv = T(f32(1, 2, 3, 4)), T(f32(1, 2, 5, 4))
    gate_w, gate_b = T(f32(4, 2, 2)), T(f32(2, 2))
    out_w, out_b = T(f32(2, 2, 4)), T(f32(4))
    merged = ga(q, qkv_weight=T(f32(3, 2, 2, 4)), gate_linear_weight=gate_w,
                gate_linear_bias=gate_b, out_linear_weight=out_w,
                out_linear_bias=out_b,
                nonbatched_bias=T(f32(1, 2, 3, 3)))
    separate = ga(q, kv, query_weight=T(f32(4, 2, 2)),
                  key_weight=T(f32(4, 2, 2)), value_weight=T(f32(4, 2, 2)),
                  out_linear_weight=out_w, out_linear_bias=out_b,
                  attn_mask=T(f32(1, 2, 1, 1, 5)), has_gating=False,
                  merge_qkv=False)
    return merged, separate


case("fused_gate_attention", _gate_attention, tol=1e-5)
INCUBATE_CASES = [c[0] for c in CASES[_INC_FIRST:]]


# ---------------------------------------------------------------------------
# the op surfaces' registered ops: fft, signal, geometric's message
# passing and segment pools, quantization's fake quant (OPSURF_CASES
# names them for chip_smoke.py's phase 32)
# ---------------------------------------------------------------------------
_OS_FIRST = len(CASES)
_NORMS = ("backward", "ortho", "forward")


def _cplx(*shape):
    return (f32(*shape) + 1j * f32(*shape)).astype(np.complex64)


# each op under one norm, the norms in turn (each reference call compiles)
for _i, _op in enumerate(("fft", "ifft", "rfft", "ihfft", "fft2", "ifft2",
                          "rfft2", "ihfft2", "fftn", "ifftn", "rfftn",
                          "ihfftn")):
    case(f"fft_{_op}", lambda P, T, op=_op, nm=_NORMS[_i % 3]: getattr(
        P.fft, op)(T(f32(3, 10)), norm=nm), tol=1e-5)
for _i, _op in enumerate(("hfft", "irfft", "hfft2", "irfft2", "hfftn",
                          "irfftn")):
    case(f"fft_{_op}", lambda P, T, op=_op, nm=_NORMS[_i % 3]: getattr(
        P.fft, op)(T(_cplx(3, 9)), norm=nm), tol=1e-5)
case("fft_sizes_axes", lambda P, T: (
    P.fft.fft(T(f32(4, 6)), n=9, axis=0),
    P.fft.rfft(T(f32(4, 6)), n=4),
    P.fft.irfft(T(_cplx(4, 5)), n=7, axis=0),
    P.fft.fftn(T(f32(2, 3, 4)), s=(5, 4), axes=(0, 2)),
    P.fft.rfft2(T(f32(2, 3, 4)), s=(4, 6)),
    P.fft.hfftn(T(_cplx(2, 3, 4)), s=(3, 6), axes=(0, 2)),
    P.fft.ihfft2(T(f32(2, 3, 4)), s=(3, 5), norm="ortho")), tol=1e-5)
# half precision promoted to complex64 / float32 (the reference's rfft
# family raises on it instead: tests/test_torch_fft_signal.py)
case("fft_half_precision", lambda P, T: (
    P.fft.fft(T(f32(2, 16)).astype("float16")),
    P.fft.fftn(T(f32(2, 12)).astype("bfloat16")),
    P.fft.irfft(T(f32(2, 9)).astype("float16")),
    P.fft.hfft(T(f32(2, 9)).astype("bfloat16"))), tol=1e-5)
case("fft_grads", lambda P, T: (
    P.fft.rfft(T(f32(3, 10)), norm="ortho").abs(),
    P.fft.fft2(T(f32(2, 3, 4))).abs(),
    P.fft.ihfftn(T(f32(2, 5))).abs(),
    P.fft.hfft(P.fft.rfft(T(f32(2, 6)))),
    P.fft.irfftn(P.fft.rfftn(T(f32(2, 4, 6))), s=(4, 6))), tol=1e-5,
    grad_tol=1e-4)
case("fft_freq_shift", lambda P, T: (
    P.fft.fftfreq(8, d=0.5), P.fft.rfftfreq(9, d=2.0),
    P.fft.fftfreq(7, dtype="float64"),
    P.fft.fftshift(T(f32(4, 5))), P.fft.fftshift(T(f32(4, 5)), axes=1),
    P.fft.ifftshift(T(f32(4, 5))),
    P.fft.ifftshift(T(f32(3, 4)), axes=[0])), tol=1e-6)
case("signal_frame", lambda P, T: (
    P.signal.frame(T(f32(2, 20)), 6, 3), P.signal.frame(T(f32(20)), 5, 5),
    P.signal.frame(T(f32(20, 3)), 4, 2, axis=0)), tol=1e-6)
case("signal_overlap_add", lambda P, T: (
    P.signal.overlap_add(T(f32(2, 6, 5)), 3),
    P.signal.overlap_add(T(f32(6, 4)), 2),
    P.signal.overlap_add(T(f32(5, 6, 3)), 4, axis=0)), tol=1e-6)


def _stft_cases(P, T):
    sig, w = T(f32(2, 200)), T(pos(48))
    return (P.signal.stft(sig, 64, 16, win_length=48, window=w,
                          normalized=True).abs(),
            P.signal.stft(T(f32(150)), 32, 20, center=False,
                          pad_mode="constant").abs(),
            P.signal.stft(T(_cplx(2, 100)), 32, 8, onesided=False).abs())


def _istft_cases(P, T):
    spec = P.signal.stft(T(f32(2, 200)), 64, 16)
    w = T(pos(64), grad=False)
    return (P.signal.istft(spec, 64, 16, window=w, length=190),
            P.signal.istft(spec, 64, 16, length=230, normalized=True),
            P.signal.istft(P.signal.stft(T(f32(120)), 32, 8, center=False),
                           32, 8, center=False))


case("signal_stft", _stft_cases, tol=1e-5, grad_tol=1e-4)
case("signal_istft", _istft_cases, tol=1e-5, grad_tol=1e-4)

_SRC = [0, 1, 2, 3, 0, 2, 4, 1, 3, 4, 2]
_DST = [1, 2, 0, 0, 3, 3, 0, 4, 2, 1, 0]


def _send_u_recv(P, T):
    x = T(f32(5, 3))
    src, dst = T(ints(*_SRC)), T(ints(*_DST))
    return [P.geometric.send_u_recv(x, src, dst, op, out_size=n)
            for op in ("sum", "mean", "max", "min") for n in (None, 6)]


def _send_ue_recv(P, T):
    x, e, e1 = T(f32(5, 3)), T(f32(11, 3)), T(pos(11))
    src, dst = T(ints(*_SRC)), T(ints(*_DST))
    G = P.geometric
    return ([G.send_ue_recv(x, e, src, dst, cop, "sum")
             for cop in ("add", "sub", "mul", "div")]
            + [G.send_ue_recv(x, e1, src, dst, "mul", rop, out_size=6)
               for rop in ("mean", "max", "min")])


def _send_uv(P, T):
    x, y = T(f32(5, 3)), T(pos(5, 3))
    src, dst = T(ints(*_SRC)), T(ints(*_DST))
    return [P.geometric.send_uv(x, y, src, dst, op)
            for op in ("add", "sub", "mul", "div")]


def _segment_pool(P, T):
    x, ids = T(f32(7, 3)), T(ints(0, 0, 1, 3, 3, 3, 4))
    G = P.geometric
    return (G.segment_sum(x, ids), G.segment_max(x, ids),
            G.segment_min(x, ids), G.segment_pool(x, ids, "AVG", out_size=6))


case("send_u_recv", _send_u_recv, tol=1e-6)
case("send_ue_recv", _send_ue_recv, tol=1e-5, grad_tol=1e-4)
case("send_uv", _send_uv, tol=1e-6, grad_tol=1e-5)
case("segment_pool", _segment_pool, tol=1e-6)
case("fake_quantize_dequantize_moving_average_abs_max", lambda P, T: (
    P.quantization._fake_quant_op(T(f32(4, 6) * 2), T(np.float32(1.1))),
    P.quantization._fake_quant_op(T(f32(3, 5)), T(np.float32(0.7)),
                                  bit_length=4)), tol=1e-6)
OPSURF_CASES = [c[0] for c in CASES[_OS_FIRST:]]


# ---------------------------------------------------------------------------
# running a case
# ---------------------------------------------------------------------------
def flat_outputs(out):
    """A case's outputs as a flat list of Tensors."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def run_case(P, fn, place=None, grad=True):
    """(output arrays, {input index: grad array}) of one case on package
    `P`, its Tensors on `place` (None: the default place)."""
    leaves = []
    _rng[0] = np.random.default_rng(4321)

    def T(a, grad=True):
        a = np.asarray(a)
        float_in = a.dtype.kind == "f"
        t = P.to_tensor(a, place=place, stop_gradient=not (grad and float_in))
        leaves.append(t)
        return t

    outs = flat_outputs(fn(P, T))
    values = [np.asarray(o.numpy()) for o in outs]
    grads = {}
    if grad:
        crng = np.random.default_rng(7)
        total = None
        for o, v in zip(outs, values):
            if o.stop_gradient or v.dtype.kind != "f":
                continue
            cot = P.to_tensor(crng.standard_normal(v.shape).astype(
                np.float32), place=place).astype(o.dtype)
            term = (o * cot).sum()
            total = term if total is None else total + term
        if total is not None:
            total.backward()
            for i, t in enumerate(leaves):
                if not t.stop_gradient and t.grad is not None:
                    grads[i] = np.asarray(t.grad.numpy())
    return values, grads


# ---------------------------------------------------------------------------
# random ops: their draws are compared only within one package
# ---------------------------------------------------------------------------
def random_draws(P):
    """One draw of each random op, in a fixed order, on the default
    place."""
    x = P.to_tensor(np.full((4,), 0.5, np.float32))
    probs = P.to_tensor(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]],
                                 np.float32))
    return [P.rand([3, 4]), P.uniform([5], min=-2.0, max=3.0),
            P.randn([2, 3]), P.normal(1.0, 2.0, [3]),
            P.normal(P.to_tensor(np.zeros(3, np.float32)),
                     P.to_tensor(np.ones(3, np.float32))),
            P.gaussian([4], mean=1.0, std=0.5), P.standard_normal([2]),
            P.randint(0, 10, [6]), P.randint_like(x, 0, 5),
            P.randperm(7), P.multinomial(probs, 2),
            P.multinomial(probs, 4, replacement=True), P.bernoulli(x),
            P.poisson(x * 4), P.rand_like(x), P.randn_like(x),
            P.ops.random.normal_like(x, 2.0, 0.1), P.binomial(x * 10, x),
            P.dirichlet(P.to_tensor(np.ones(3, np.float32))),
            P.standard_gamma(x + 1.0), P.truncated_normal([8]),
            P.exponential_(P.to_tensor(np.zeros(5, np.float32)), 2.0)]


def _full(P, n, v):
    return P.to_tensor(np.full(n, v, np.float32))


# (name, draw(P, n), mean, standard deviation) of n draws
RANDOM_MOMENTS = [
    ("rand", lambda P, n: P.rand([n]), 0.5, (1 / 12) ** 0.5),
    ("uniform", lambda P, n: P.uniform([n], min=-2.0, max=3.0), 0.5,
     5 / 12 ** 0.5),
    ("randn", lambda P, n: P.randn([n]), 0.0, 1.0),
    ("normal", lambda P, n: P.normal(1.0, 2.0, [n]), 1.0, 2.0),
    ("gaussian", lambda P, n: P.gaussian([n], mean=-1.0, std=0.5), -1.0,
     0.5),
    ("randint", lambda P, n: P.randint(0, 10, [n]), 4.5, (99 / 12) ** 0.5),
    ("bernoulli", lambda P, n: P.bernoulli(_full(P, n, 0.3)), 0.3,
     0.21 ** 0.5),
    ("poisson", lambda P, n: P.poisson(_full(P, n, 4.0)), 4.0, 2.0),
    ("binomial", lambda P, n: P.binomial(_full(P, n, 10.0),
                                         _full(P, n, 0.3)), 3.0,
     2.1 ** 0.5),
    ("standard_gamma", lambda P, n: P.standard_gamma(_full(P, n, 2.0)),
     2.0, 2.0 ** 0.5),
    ("exponential", lambda P, n: P.exponential_(_full(P, n, 0.0), 2.0),
     0.5, 0.5),
    # a standard normal truncated to [-2, 2]
    ("truncated_normal", lambda P, n: P.truncated_normal([n]), 0.0, 0.8796),
]


def moments_ok(a, mean, sd):
    """(ok, mean, sd) of draws `a` (numpy): the mean within 6 standard
    errors of the distribution's, the deviation within 2 % (+ 1e-3)."""
    a = np.asarray(a, np.float64)
    m, s = a.mean(), a.std()
    ok = abs(m - mean) < 6 * sd / len(a) ** 0.5 and \
        abs(s - sd) < 0.02 * sd + 1e-3
    return ok, float(m), float(s)
