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
