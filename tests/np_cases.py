"""Calls of every ``mx.np`` / ``mx.npx`` name, shared by the CPU parity
test (``tests/test_torch_numpy.py``: the JAX package's namespace against
the port's) and by ``chip_smoke.py`` (the port on the card against the
port on the CPU). Imports neither package: each case takes the namespaces
it is given.

``inputs(np)`` makes the arrays of every case from one numpy seed in the
current context; a case is ``(label, fn)`` with ``fn(np, npx, X)``
returning arrays, tuples or lists of them, Python scalars or dtypes.
Where the answer is defined only up to a choice the two implementations
may make differently (the signs of singular and eigen vectors, the order
inside a partition), the case returns what is unique (a reconstruction,
sorted values).
"""
import io

import numpy as onp

#: float32 results within ATOL + RTOL · |want|; ints and bools exact
ATOL, RTOL = 1e-5, 1e-6


def inputs(np):
    rng = onp.random.RandomState(7)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    a = f(3, 4)
    spd = f(4, 4)
    spd = spd @ spd.T + 4 * onp.eye(4, dtype="float32")
    an = a.copy()
    an[0, 1] = an[2, 3] = onp.nan
    raw = {
        "A": a, "B": f(3, 4), "P": onp.abs(f(3, 4)) + 0.5,
        "U": rng.uniform(-0.9, 0.9, (3, 4)).astype("float32"),
        "I": rng.randint(-5, 6, (3, 4)).astype("int32"),
        "J": rng.randint(1, 6, (3, 4)).astype("int32"),
        "N": rng.randint(0, 7, (10,)).astype("int32"),
        "V": f(6), "V3": f(3), "V4": f(4),
        "W": onp.sort(f(5)), "A3": f(2, 3, 4), "S": spd, "An": an,
        "T3": f(2, 2, 2, 2), "Bits": rng.randint(0, 256, (6,)).astype(
            "uint8"),
        "M": f(10, 2), "Img": rng.uniform(0, 255, (6, 8, 3)).astype(
            "float32"),
        "X4": f(2, 3, 6, 6), "Wc": f(4, 3, 3, 3), "Wd": f(3, 4, 3, 3),
        "G": onp.abs(f(3)) + 0.5,
    }
    X = {k: np.array(v, dtype=v.dtype.name) for k, v in raw.items()}
    X["raw"] = raw
    return X


def _part_check(np, r, v, k):
    """A partition's two sides, each sorted (the order inside is free)."""
    h = onp.asarray(r.asnumpy())
    return onp.sort(h[..., :k + 1], -1), onp.sort(h[..., k + 1:], -1)


def _argpart(np, X):
    v = X["raw"]["V"]
    r = np.argpartition(X["V"], 2).asnumpy()
    return onp.sort(v[r[:3]]), onp.sort(v[r[3:]])


def _recon_svd(np, X):
    u, s, vt = np.linalg.svd(X["A"])
    return s, np.matmul(np.matmul(u, np.diag(s)), vt)


def _recon_eigh(np, X):
    w, v = np.linalg.eigh(X["S"])
    return w, np.matmul(np.matmul(v, np.diag(w)), v.T)


def _recon_qr(np, X):
    q, r = np.linalg.qr(X["A"].T)
    return np.abs(np.diag(r)), np.matmul(q, r)


def _recon_eig(np, X):
    w, v = np.linalg.eig(X["S"])
    return onp.sort(onp.real(onp.asarray(w.asnumpy())))


def _lstsq(np, X):
    x, resid, rank, s = np.linalg.lstsq(X["A"].T, X["V4"])
    return x, resid, rank, s


NP_CASES = [
    ("abs", lambda np, npx, X: np.abs(X["A"])),
    ("absolute", lambda np, npx, X: np.absolute(X["I"])),
    ("add", lambda np, npx, X: np.add(X["A"], X["B"])),
    ("add_scalar", lambda np, npx, X: np.add(X["I"], 2.5)),
    ("allclose", lambda np, npx, X: np.allclose(X["A"], X["A"] + 1e-9)),
    ("alltrue", lambda np, npx, X: np.alltrue(X["A"] > -10)),
    ("append", lambda np, npx, X: np.append(X["A"], X["B"], axis=0)),
    ("append_flat", lambda np, npx, X: np.append(X["A"], X["V"])),
    ("apply_along_axis", lambda np, npx, X: np.apply_along_axis(
        lambda r: r * 2, 1, X["A"])),
    ("apply_over_axes", lambda np, npx, X: np.apply_over_axes(
        lambda a, ax: a.sum(axis=ax, keepdims=True), X["A"], [0])),
    ("arange", lambda np, npx, X: np.arange(1, 7, 2)),
    ("arange_float", lambda np, npx, X: np.arange(0.0, 1.0, 0.25)),
    ("arccos", lambda np, npx, X: np.arccos(X["U"])),
    ("arccosh", lambda np, npx, X: np.arccosh(X["P"] + 1)),
    ("arcsin", lambda np, npx, X: np.arcsin(X["U"])),
    ("arcsinh", lambda np, npx, X: np.arcsinh(X["A"])),
    ("arctan", lambda np, npx, X: np.arctan(X["A"])),
    ("arctan2", lambda np, npx, X: np.arctan2(X["A"], X["B"])),
    ("arctanh", lambda np, npx, X: np.arctanh(X["U"])),
    ("argmax", lambda np, npx, X: np.argmax(X["A"], axis=1)),
    ("argmax_flat", lambda np, npx, X: np.argmax(X["A"])),
    ("argmin", lambda np, npx, X: np.argmin(X["A"], axis=0)),
    ("argpartition", lambda np, npx, X: _argpart(np, X)),
    ("argsort", lambda np, npx, X: np.argsort(X["A"], axis=1)),
    ("argwhere", lambda np, npx, X: np.argwhere(X["A"] > 0)),
    ("around", lambda np, npx, X: np.around(X["A"], 2)),
    ("array", lambda np, npx, X: np.array([[1, 2], [3, 4]])),
    ("array_equal", lambda np, npx, X: np.array_equal(X["A"], X["A"])),
    ("array_equiv", lambda np, npx, X: np.array_equiv(X["A"], X["A"][0])),
    ("array_split", lambda np, npx, X: np.array_split(X["V"], 4)),
    ("average", lambda np, npx, X: np.average(X["A"], axis=1,
                                              weights=X["P"][0])),
    ("average_plain", lambda np, npx, X: np.average(X["A"], axis=0,
                                                    returned=True)),
    ("bincount", lambda np, npx, X: np.bincount(X["N"])),
    ("bincount_w", lambda np, npx, X: np.bincount(X["N"], np.ones((10,)))),
    ("bitwise_and", lambda np, npx, X: np.bitwise_and(X["I"], X["J"])),
    ("bitwise_not", lambda np, npx, X: np.bitwise_not(X["I"])),
    ("bitwise_or", lambda np, npx, X: np.bitwise_or(X["I"], X["J"])),
    ("bitwise_xor", lambda np, npx, X: np.bitwise_xor(X["I"], X["J"])),
    ("blackman", lambda np, npx, X: np.blackman(7)),
    ("broadcast_arrays", lambda np, npx, X: np.broadcast_arrays(
        X["A"], X["V4"])),
    ("broadcast_to", lambda np, npx, X: np.broadcast_to(X["V4"], (3, 4))),
    ("cbrt", lambda np, npx, X: np.cbrt(X["A"])),
    ("ceil", lambda np, npx, X: np.ceil(X["A"])),
    ("choose", lambda np, npx, X: np.choose(np.clip(X["J"], 0, 2),
                                            [X["A"], X["B"], X["P"]])),
    ("clip", lambda np, npx, X: np.clip(X["A"], -0.5, 0.5)),
    ("column_stack", lambda np, npx, X: np.column_stack([X["V"], X["V"]])),
    ("compress", lambda np, npx, X: np.compress(
        np.array([1, 0, 1], dtype="bool"), X["A"], axis=0)),
    ("concatenate", lambda np, npx, X: np.concatenate([X["A"], X["B"]],
                                                      axis=1)),
    ("copysign", lambda np, npx, X: np.copysign(X["A"], X["B"])),
    ("corrcoef", lambda np, npx, X: np.corrcoef(X["A"])),
    ("correlate", lambda np, npx, X: np.correlate(X["V"], X["V3"])),
    ("correlate_full", lambda np, npx, X: np.correlate(X["V"], X["V3"],
                                                       "full")),
    ("cos", lambda np, npx, X: np.cos(X["A"])),
    ("cosh", lambda np, npx, X: np.cosh(X["A"])),
    ("count_nonzero", lambda np, npx, X: np.count_nonzero(X["I"], axis=0)),
    ("cov", lambda np, npx, X: np.cov(X["A"])),
    ("cov_cols", lambda np, npx, X: np.cov(X["A"], rowvar=False, bias=True)),
    ("cumsum", lambda np, npx, X: np.cumsum(X["A"], axis=1)),
    ("cumsum_int", lambda np, npx, X: np.cumsum(X["I"])),
    ("deg2rad", lambda np, npx, X: np.deg2rad(X["A"])),
    ("degrees", lambda np, npx, X: np.degrees(X["A"])),
    ("delete", lambda np, npx, X: np.delete(X["A"], 1, axis=1)),
    ("diag_indices_from", lambda np, npx, X: np.diag_indices_from(X["S"])),
    ("diff", lambda np, npx, X: np.diff(X["A"], axis=1)),
    ("digitize", lambda np, npx, X: np.digitize(X["V"], X["W"])),
    ("digitize_right", lambda np, npx, X: np.digitize(X["V"], X["W"],
                                                      right=True)),
    ("divide", lambda np, npx, X: np.divide(X["A"], X["P"])),
    ("divide_int", lambda np, npx, X: np.divide(X["I"], X["J"])),
    ("divmod", lambda np, npx, X: np.divmod(X["I"], X["J"])),
    ("dsplit", lambda np, npx, X: np.dsplit(X["A3"], 2)),
    ("dstack", lambda np, npx, X: np.dstack([X["A"], X["B"]])),
    ("dtype", lambda np, npx, X: np.dtype("float32")),
    ("e", lambda np, npx, X: np.e),
    ("ediff1d", lambda np, npx, X: np.ediff1d(X["V"])),
    ("einsum", lambda np, npx, X: np.einsum("ij,kj->ik", X["A"], X["B"])),
    ("empty", lambda np, npx, X: np.empty((2, 3))),
    ("empty_like", lambda np, npx, X: np.empty_like(X["A"])),
    ("equal", lambda np, npx, X: np.equal(X["I"], X["J"])),
    ("exp", lambda np, npx, X: np.exp(X["A"])),
    ("expand_dims", lambda np, npx, X: np.expand_dims(X["A"], 1)),
    ("expm1", lambda np, npx, X: np.expm1(X["A"])),
    ("extract", lambda np, npx, X: np.extract(X["A"] > 0, X["A"])),
    ("eye", lambda np, npx, X: np.eye(3, 4, 1)),
    ("fabs", lambda np, npx, X: np.fabs(X["A"])),
    ("finfo", lambda np, npx, X: float(np.finfo(np.float32).eps)),
    ("fix", lambda np, npx, X: np.fix(X["A"] * 3)),
    ("flatnonzero", lambda np, npx, X: np.flatnonzero(X["I"])),
    ("flip", lambda np, npx, X: np.flip(X["A"], 1)),
    ("fliplr", lambda np, npx, X: np.fliplr(X["A"])),
    ("flipud", lambda np, npx, X: np.flipud(X["A"])),
    ("float_power", lambda np, npx, X: np.float_power(X["P"], X["B"])),
    ("floor", lambda np, npx, X: np.floor(X["A"])),
    ("frexp", lambda np, npx, X: np.frexp(X["A"])),
    ("full", lambda np, npx, X: np.full((2, 2), 3.0)),
    ("full_like", lambda np, npx, X: np.full_like(X["A"], 2)),
    ("genfromtxt", lambda np, npx, X: np.genfromtxt(io.StringIO(
        "1 2\n3 4"))),
    ("greater", lambda np, npx, X: np.greater(X["A"], X["B"])),
    ("greater_equal", lambda np, npx, X: np.greater_equal(X["I"], X["J"])),
    ("hamming", lambda np, npx, X: np.hamming(6)),
    ("hanning", lambda np, npx, X: np.hanning(6)),
    ("heaviside", lambda np, npx, X: np.heaviside(X["I"] * 1.0, 0.5)),
    ("histogram", lambda np, npx, X: np.histogram(X["V"], bins=4)),
    ("histogram2d", lambda np, npx, X: np.histogram2d(X["V"], X["V"] * 2,
                                                      bins=3)),
    ("histogram_bin_edges", lambda np, npx, X: np.histogram_bin_edges(
        X["V"], 4)),
    ("histogramdd", lambda np, npx, X: np.histogramdd(X["M"], bins=3)),
    ("hsplit", lambda np, npx, X: np.hsplit(X["A"], 2)),
    ("hstack", lambda np, npx, X: np.hstack([X["A"], X["B"]])),
    ("hypot", lambda np, npx, X: np.hypot(X["A"], X["B"])),
    ("i0", lambda np, npx, X: np.i0(X["A"])),
    ("identity", lambda np, npx, X: np.identity(3)),
    ("in1d", lambda np, npx, X: np.in1d(X["I"], X["J"])),
    ("indices", lambda np, npx, X: np.indices((2, 3))),
    ("inf", lambda np, npx, X: np.inf),
    ("inner", lambda np, npx, X: np.inner(X["A"], X["B"])),
    ("insert", lambda np, npx, X: np.insert(X["V"], 1, 5.0)),
    ("interp", lambda np, npx, X: np.interp(X["V"], X["W"], X["W"] * 2)),
    ("intersect1d", lambda np, npx, X: np.intersect1d(X["I"], X["J"])),
    ("invert", lambda np, npx, X: np.invert(X["I"])),
    ("isclose", lambda np, npx, X: np.isclose(X["A"], X["B"] * 0 + X["A"])),
    ("isfinite", lambda np, npx, X: np.isfinite(X["An"])),
    ("isin", lambda np, npx, X: np.isin(X["I"], X["J"])),
    ("isinf", lambda np, npx, X: np.isinf(X["An"])),
    ("isnan", lambda np, npx, X: np.isnan(X["An"])),
    ("isneginf", lambda np, npx, X: np.isneginf(X["A"] / 0.0)),
    ("isposinf", lambda np, npx, X: np.isposinf(X["A"] / 0.0)),
    ("ix_", lambda np, npx, X: np.ix_(np.array([0, 1], dtype="int32"),
                                      np.array([2, 0, 1], dtype="int32"))),
    ("lcm", lambda np, npx, X: np.lcm(X["J"], X["J"] + 1)),
    ("ldexp", lambda np, npx, X: np.ldexp(X["A"], X["I"])),
    ("less", lambda np, npx, X: np.less(X["A"], X["B"])),
    ("less_equal", lambda np, npx, X: np.less_equal(X["I"], X["J"])),
    ("lexsort", lambda np, npx, X: np.lexsort((X["N"], X["N"] % 3))),
    ("linspace", lambda np, npx, X: np.linspace(0, 1, 7)),
    ("log", lambda np, npx, X: np.log(X["P"])),
    ("log10", lambda np, npx, X: np.log10(X["P"])),
    ("log1p", lambda np, npx, X: np.log1p(X["P"])),
    ("log2", lambda np, npx, X: np.log2(X["P"])),
    ("logical_not", lambda np, npx, X: np.logical_not(X["A"] > 0)),
    ("logspace", lambda np, npx, X: np.logspace(0, 2, 5)),
    ("matmul", lambda np, npx, X: np.matmul(X["A"], X["B"].T)),
    ("maximum", lambda np, npx, X: np.maximum(X["A"], X["B"])),
    ("maximum_scalar", lambda np, npx, X: np.maximum(X["A"], 0.5)),
    ("mean", lambda np, npx, X: np.mean(X["A"], axis=0)),
    ("mean_int", lambda np, npx, X: np.mean(X["I"])),
    ("meshgrid", lambda np, npx, X: np.meshgrid(X["V3"], X["V4"])),
    ("min_scalar_type", lambda np, npx, X: str(np.min_scalar_type(10))),
    ("minimum", lambda np, npx, X: np.minimum(X["A"], X["B"])),
    ("mirr", lambda np, npx, X: np.mirr([-100.0, 30, 40, 50], 0.1, 0.12)),
    ("mod", lambda np, npx, X: np.mod(X["A"], X["P"])),
    ("modf", lambda np, npx, X: np.modf(X["A"] * 3)),
    ("msort", lambda np, npx, X: np.msort(X["A"])),
    ("multiply", lambda np, npx, X: np.multiply(X["A"], X["B"])),
    ("nan_to_num", lambda np, npx, X: np.nan_to_num(X["An"])),
    ("nanargmax", lambda np, npx, X: np.nanargmax(X["An"], axis=1)),
    ("nanargmin", lambda np, npx, X: np.nanargmin(X["An"], axis=1)),
    ("nancumprod", lambda np, npx, X: np.nancumprod(X["An"], axis=1)),
    ("nancumsum", lambda np, npx, X: np.nancumsum(X["An"], axis=1)),
    ("nanmax", lambda np, npx, X: np.nanmax(X["An"], axis=1)),
    ("nanmedian", lambda np, npx, X: np.nanmedian(X["An"], axis=1)),
    ("nanmin", lambda np, npx, X: np.nanmin(X["An"], axis=0)),
    ("nanpercentile", lambda np, npx, X: np.nanpercentile(X["An"], 30,
                                                          axis=1)),
    ("nanprod", lambda np, npx, X: np.nanprod(X["An"], axis=1)),
    ("nanquantile", lambda np, npx, X: np.nanquantile(X["An"], 0.3)),
    ("ndim", lambda np, npx, X: np.ndim(X["A3"])),
    ("negative", lambda np, npx, X: np.negative(X["A"])),
    ("nonzero", lambda np, npx, X: np.nonzero(X["I"])),
    ("not_equal", lambda np, npx, X: np.not_equal(X["I"], X["J"])),
    ("npv", lambda np, npx, X: np.npv(0.1, X["V"])),
    ("ones", lambda np, npx, X: np.ones((2, 3))),
    ("ones_like", lambda np, npx, X: np.ones_like(X["I"])),
    ("outer", lambda np, npx, X: np.outer(X["V"], X["V3"])),
    ("packbits", lambda np, npx, X: np.packbits(X["A"] > 0)),
    ("pad_constant", lambda np, npx, X: np.pad(X["A"], ((1, 2), (0, 1)))),
    ("pad_reflect", lambda np, npx, X: np.pad(X["A"], 2, mode="reflect")),
    ("pad_edge", lambda np, npx, X: np.pad(X["A"], ((1, 0), (2, 1)),
                                           mode="edge")),
    ("pad_symmetric", lambda np, npx, X: np.pad(X["A"], 1,
                                                mode="symmetric")),
    ("pad_wrap", lambda np, npx, X: np.pad(X["A"], 2, mode="wrap")),
    ("partition", lambda np, npx, X: _part_check(
        np, np.partition(X["A"], 1, axis=1), X["A"], 1)),
    ("percentile", lambda np, npx, X: np.percentile(X["A"], 30, axis=1)),
    ("pi", lambda np, npx, X: np.pi),
    ("piecewise", lambda np, npx, X: np.piecewise(
        X["V"], [X["V"] < 0, X["V"] >= 0], [-1.0, 1.0])),
    ("poly", lambda np, npx, X: np.poly(np.array([1.0, 2.0]))),
    ("polyadd", lambda np, npx, X: np.polyadd(X["V3"], X["V"])),
    ("polydiv", lambda np, npx, X: np.polydiv(X["V"], X["V3"])),
    ("polyfit", lambda np, npx, X: np.polyfit(X["W"], X["W"] * 2 + 1, 1)),
    ("polyint", lambda np, npx, X: np.polyint(X["V3"])),
    ("polymul", lambda np, npx, X: np.polymul(X["V3"], X["V4"])),
    ("polysub", lambda np, npx, X: np.polysub(X["V"], X["V3"])),
    ("polyval", lambda np, npx, X: np.polyval(X["V3"], X["V"])),
    ("positive", lambda np, npx, X: np.positive(X["A"])),
    ("power", lambda np, npx, X: np.power(X["P"], X["B"])),
    ("ppmt", lambda np, npx, X: np.ppmt(0.1, 2, 3, 1000.0)),
    ("promote_types", lambda np, npx, X: str(np.promote_types(
        "float32", "int32"))),
    ("ptp", lambda np, npx, X: np.ptp(X["A"], axis=1)),
    ("pv", lambda np, npx, X: np.pv(0.1, 3, -402.11)),
    ("quantile", lambda np, npx, X: np.quantile(X["A"], 0.4)),
    ("quantile_nearest", lambda np, npx, X: np.quantile(
        X["A"], 0.4, axis=0, interpolation="nearest")),
    ("rad2deg", lambda np, npx, X: np.rad2deg(X["A"])),
    ("radians", lambda np, npx, X: np.radians(X["A"])),
    ("rate", lambda np, npx, X: np.rate(3, -402.11, 1000.0, 0.0)),
    ("ravel", lambda np, npx, X: np.ravel(X["A"])),
    ("real", lambda np, npx, X: np.real(X["A"])),
    ("reciprocal", lambda np, npx, X: np.reciprocal(X["P"])),
    ("remainder", lambda np, npx, X: np.remainder(X["I"], X["J"])),
    ("resize", lambda np, npx, X: np.resize(X["V"], (2, 5))),
    ("result_type", lambda np, npx, X: str(np.result_type(X["A"], X["I"]))),
    ("rint", lambda np, npx, X: np.rint(X["A"] * 3)),
    ("rollaxis", lambda np, npx, X: np.rollaxis(X["A3"], 2)),
    ("roots", lambda np, npx, X: np.roots(np.array([1.0, -3.0, 2.0]))),
    ("rot90", lambda np, npx, X: np.rot90(X["A"])),
    ("round", lambda np, npx, X: np.round(X["A"] * 3)),
    ("round_", lambda np, npx, X: np.round_(X["A"], 1)),
    ("row_stack", lambda np, npx, X: np.row_stack([X["A"], X["B"]])),
    ("searchsorted", lambda np, npx, X: np.searchsorted(X["W"], X["V"])),
    ("select", lambda np, npx, X: np.select([X["V"] < 0, X["V"] > 0.5],
                                            [X["V"], X["V"] * 2])),
    ("setdiff1d", lambda np, npx, X: np.setdiff1d(X["I"], X["J"])),
    ("setxor1d", lambda np, npx, X: np.setxor1d(X["I"], X["J"])),
    ("shape", lambda np, npx, X: np.shape(X["A3"])),
    ("shares_memory", lambda np, npx, X: np.shares_memory(X["A"], X["B"])),
    ("sign", lambda np, npx, X: np.sign(X["I"])),
    ("signbit", lambda np, npx, X: np.signbit(X["A"])),
    ("sin", lambda np, npx, X: np.sin(X["A"])),
    ("sinh", lambda np, npx, X: np.sinh(X["A"])),
    ("size", lambda np, npx, X: np.size(X["A3"])),
    ("sort", lambda np, npx, X: np.sort(X["A"])),
    ("spacing", lambda np, npx, X: float(np.spacing(1.0))),
    ("split", lambda np, npx, X: np.split(X["V"], 3)),
    ("split_idx", lambda np, npx, X: np.split(X["V"], [1, 4])),
    ("sqrt", lambda np, npx, X: np.sqrt(X["P"])),
    ("square", lambda np, npx, X: np.square(X["A"])),
    ("stack", lambda np, npx, X: np.stack([X["A"], X["B"]], 1)),
    ("std", lambda np, npx, X: np.std(X["A"], axis=1)),
    ("subtract", lambda np, npx, X: np.subtract(X["A"], X["B"])),
    ("swapaxes", lambda np, npx, X: np.swapaxes(X["A3"], 0, 2)),
    ("take", lambda np, npx, X: np.take(X["A"], np.array(
        [0, 2], dtype="int32"), axis=1)),
    ("take_flat", lambda np, npx, X: np.take(X["A"], np.array(
        [5, 0, 11], dtype="int32"))),
    ("take_along_axis", lambda np, npx, X: np.take_along_axis(
        X["A"], np.argsort(X["A"], axis=1), axis=1)),
    ("tan", lambda np, npx, X: np.tan(X["U"])),
    ("tanh", lambda np, npx, X: np.tanh(X["A"])),
    ("tensordot", lambda np, npx, X: np.tensordot(X["A"], X["B"],
                                                  axes=([1], [1]))),
    ("tile", lambda np, npx, X: np.tile(X["V"], 2)),
    ("trapz", lambda np, npx, X: np.trapz(X["V"])),
    ("tril", lambda np, npx, X: np.tril(X["A"], -1)),
    ("tril_indices_from", lambda np, npx, X: np.tril_indices_from(X["S"])),
    ("trim_zeros", lambda np, npx, X: np.trim_zeros(np.array(
        [0.0, 0.0, 1.0, 2.0, 0.0]))),
    ("triu_indices_from", lambda np, npx, X: np.triu_indices_from(X["S"],
                                                                  1)),
    ("true_divide", lambda np, npx, X: np.true_divide(X["A"], X["P"])),
    ("trunc", lambda np, npx, X: np.trunc(X["A"] * 3)),
    ("union1d", lambda np, npx, X: np.union1d(X["I"], X["J"])),
    ("unique", lambda np, npx, X: np.unique(X["I"], return_counts=True)),
    ("unique_inverse", lambda np, npx, X: np.unique(
        X["N"], return_index=True, return_inverse=True)),
    ("unpackbits", lambda np, npx, X: np.unpackbits(X["Bits"])),
    ("unravel_index", lambda np, npx, X: np.unravel_index(X["N"], (2, 5))),
    ("unwrap", lambda np, npx, X: np.unwrap(X["V"] * 3)),
    ("vander", lambda np, npx, X: np.vander(X["V3"])),
    ("var", lambda np, npx, X: np.var(X["A"], axis=0)),
    ("vdot", lambda np, npx, X: np.vdot(X["A"], X["B"])),
    ("vsplit", lambda np, npx, X: np.vsplit(X["S"], 2)),
    ("vstack", lambda np, npx, X: np.vstack([X["A"], X["B"]])),
    ("where", lambda np, npx, X: np.where(X["A"] > 0, X["A"], X["B"])),
    ("where_1arg", lambda np, npx, X: np.where(X["I"] > 0)),
    ("zeros", lambda np, npx, X: np.zeros((2,))),
    ("zeros_like", lambda np, npx, X: np.zeros_like(X["A"])),
    # names of the reference's __all__ beyond MXNet's list above
    ("sum", lambda np, npx, X: np.sum(X["A"], axis=(0, 1))),
    ("sum_int", lambda np, npx, X: np.sum(X["I"], axis=1)),
    ("prod", lambda np, npx, X: np.prod(X["P"], axis=1)),
    ("max", lambda np, npx, X: np.max(X["A"], axis=1, keepdims=True)),
    ("min", lambda np, npx, X: np.min(X["I"])),
    ("amax", lambda np, npx, X: np.amax(X["A"])),
    ("amin", lambda np, npx, X: np.amin(X["A"], axis=0)),
    ("all", lambda np, npx, X: np.all(X["I"], axis=0)),
    ("any", lambda np, npx, X: np.any(X["A"] > 1)),
    ("median", lambda np, npx, X: np.median(X["A"], axis=1)),
    ("median_flat", lambda np, npx, X: np.median(X["A"])),
    ("nansum", lambda np, npx, X: np.nansum(X["An"], axis=1)),
    ("nanmean", lambda np, npx, X: np.nanmean(X["An"], axis=1)),
    ("nanstd", lambda np, npx, X: np.nanstd(X["An"], axis=1)),
    ("nanvar", lambda np, npx, X: np.nanvar(X["An"])),
    ("cumprod", lambda np, npx, X: np.cumprod(X["P"], axis=0)),
    ("dot", lambda np, npx, X: np.dot(X["A"], X["B"].T)),
    ("dot_nd", lambda np, npx, X: np.dot(X["A3"], X["V4"])),
    ("kron", lambda np, npx, X: np.kron(X["V3"], X["V4"])),
    ("trace", lambda np, npx, X: np.trace(X["A"], 1)),
    ("diag", lambda np, npx, X: np.diag(X["A"])),
    ("diag_1d", lambda np, npx, X: np.diag(X["V3"], 1)),
    ("triu", lambda np, npx, X: np.triu(X["A"])),
    ("cross", lambda np, npx, X: np.cross(X["A"][:, :3], X["B"][:, :3])),
    ("repeat", lambda np, npx, X: np.repeat(X["A"], 2, axis=1)),
    ("roll", lambda np, npx, X: np.roll(X["A"], 2, axis=1)),
    ("roll_flat", lambda np, npx, X: np.roll(X["A"], 5)),
    ("transpose", lambda np, npx, X: np.transpose(X["A3"], (1, 0, 2))),
    ("reshape", lambda np, npx, X: np.reshape(X["A3"], (4, -1))),
    ("squeeze", lambda np, npx, X: np.squeeze(X["A"][:1])),
    ("moveaxis", lambda np, npx, X: np.moveaxis(X["A3"], 0, -1)),
    ("tri", lambda np, npx, X: np.tri(3, 4, 1)),
    ("ravel_multi_index", lambda np, npx, X: np.ravel_multi_index(
        (np.array([0, 1, 2], dtype="int32"),
         np.array([3, 0, 1], dtype="int32")), (3, 4))),
    ("tril_indices", lambda np, npx, X: np.tril_indices(3, 0, 4)),
    ("triu_indices", lambda np, npx, X: np.triu_indices(4, 1)),
    ("diag_indices", lambda np, npx, X: np.diag_indices(3)),
    ("gcd", lambda np, npx, X: np.gcd(X["I"], X["J"])),
    ("fmod", lambda np, npx, X: np.fmod(X["A"], X["P"])),
    ("sinc", lambda np, npx, X: np.sinc(X["A"])),
    ("logaddexp", lambda np, npx, X: np.logaddexp(X["A"], X["B"])),
    ("left_shift", lambda np, npx, X: np.left_shift(X["J"], X["J"])),
    ("right_shift", lambda np, npx, X: np.right_shift(X["J"] * 16, X["J"])),
    ("floor_divide", lambda np, npx, X: np.floor_divide(X["I"], X["J"])),
    ("floor_divide_f", lambda np, npx, X: np.floor_divide(X["A"], X["P"])),
    ("gradient", lambda np, npx, X: np.gradient(X["A"])),
    ("exp2", lambda np, npx, X: np.exp2(X["A"])),
    ("logical_and", lambda np, npx, X: np.logical_and(X["A"] > 0,
                                                      X["B"] > 0)),
    ("logical_xor", lambda np, npx, X: np.logical_xor(X["A"] > 0,
                                                      X["B"] > 0)),
    ("count_nonzero_all", lambda np, npx, X: np.count_nonzero(X["I"])),
    ("imag", lambda np, npx, X: np.imag(X["A"])),
    ("conj", lambda np, npx, X: np.conj(X["A"])),
    ("atleast_3d", lambda np, npx, X: np.atleast_3d(X["V"])),
    ("vander_inc", lambda np, npx, X: np.vander(X["V3"], 4,
                                                increasing=True)),
    ("interp_lr", lambda np, npx, X: np.interp(X["V"], X["W"], X["W"],
                                               left=-9.0, right=9.0)),
    ("ndarray_ops", lambda np, npx, X: (X["A"].T, X["A"].mean(axis=1),
                                        X["A"].std(), X["A"][X["A"] > 0],
                                        X["A"].reshape(4, 3),
                                        X["A"] == X["B"], X["A"] != 0.5)),
]

LINALG_CASES = [
    ("linalg.norm", lambda np, npx, X: np.linalg.norm(X["A"])),
    ("linalg.norm_axis", lambda np, npx, X: np.linalg.norm(X["A"], 1,
                                                           axis=1)),
    ("linalg.norm_fro", lambda np, npx, X: np.linalg.norm(X["A"], "fro")),
    ("linalg.svd", lambda np, npx, X: _recon_svd(np, X)),
    ("linalg.cholesky", lambda np, npx, X: np.linalg.cholesky(X["S"])),
    ("linalg.inv", lambda np, npx, X: np.linalg.inv(X["S"])),
    ("linalg.det", lambda np, npx, X: np.linalg.det(X["S"])),
    ("linalg.slogdet", lambda np, npx, X: np.linalg.slogdet(X["S"])),
    ("linalg.solve", lambda np, npx, X: np.linalg.solve(X["S"], X["V4"])),
    ("linalg.tensorinv", lambda np, npx, X: np.linalg.tensorinv(
        np.reshape(X["S"], (2, 2, 2, 2)), ind=2)),
    ("linalg.tensorsolve", lambda np, npx, X: np.linalg.tensorsolve(
        np.reshape(X["S"], (2, 2, 2, 2)), np.reshape(X["V4"], (2, 2)))),
    ("linalg.pinv", lambda np, npx, X: np.linalg.pinv(X["A"])),
    ("linalg.eigvals", lambda np, npx, X: onp.sort(onp.real(
        np.linalg.eigvals(X["S"]).asnumpy()))),
    ("linalg.eig", lambda np, npx, X: _recon_eig(np, X)),
    ("linalg.eigvalsh", lambda np, npx, X: np.linalg.eigvalsh(X["S"])),
    ("linalg.eigh", lambda np, npx, X: _recon_eigh(np, X)),
    ("linalg.qr", lambda np, npx, X: _recon_qr(np, X)),
    ("linalg.lstsq", lambda np, npx, X: _lstsq(np, X)),
    ("linalg.matrix_rank", lambda np, npx, X: np.linalg.matrix_rank(X["A"])),
]


def _mbox_prior(npx, X):
    return npx.multibox_prior(X["X4"], sizes=(0.5, 0.25), ratios=(1, 2))


def _mbox_target(np, npx, X):
    anchors = _mbox_prior(npx, X)
    label = np.array([[[0, 0.1, 0.1, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.9]],
                      [[1, 0.2, 0.2, 0.7, 0.8], [-1, 0, 0, 0, 0]]])
    n = anchors.shape[1]
    cls = np.zeros((2, 3, n))
    return npx.multibox_target(anchors, label, cls)


def _mbox_detection(np, npx, X):
    anchors = _mbox_prior(npx, X)
    n = anchors.shape[1]
    rng = onp.random.RandomState(3)
    cls = onp.abs(rng.rand(2, 3, n)).astype("float32")
    cls = cls / cls.sum(1, keepdims=True)
    loc = (rng.randn(2, n * 4) * 0.1).astype("float32")
    return npx.multibox_detection(np.array(cls), np.array(loc), anchors,
                                  nms_threshold=0.5)


def _rnn(np, npx, X):
    rng = onp.random.RandomState(4)
    h, i = 3, 4
    n_param = 4 * h * (i + h) + 8 * h
    params = np.array((rng.randn(n_param) * 0.1).astype("float32"))
    data = np.array(rng.randn(5, 2, i).astype("float32"))
    state = np.zeros((1, 2, h))
    cell = np.zeros((1, 2, h))
    return npx.rnn(data, params, state, cell, state_size=h, num_layers=1,
                   mode="lstm")


NPX_CASES = [
    ("npx.relu", lambda np, npx, X: npx.relu(X["A"])),
    ("npx.sigmoid", lambda np, npx, X: npx.sigmoid(X["A"])),
    ("npx.softmax", lambda np, npx, X: npx.softmax(X["A"])),
    ("npx.log_softmax", lambda np, npx, X: npx.log_softmax(X["A"], axis=0)),
    ("npx.activation", lambda np, npx, X: npx.activation(X["A"],
                                                         act_type="tanh")),
    ("npx.arange_like", lambda np, npx, X: npx.arange_like(X["A"], axis=1)),
    ("npx.batch_dot", lambda np, npx, X: npx.batch_dot(
        X["A3"], np.swapaxes(X["A3"], 1, 2))),
    ("npx.batch_flatten", lambda np, npx, X: npx.batch_flatten(X["A3"])),
    ("npx.batch_norm", lambda np, npx, X: npx.batch_norm(
        X["X4"], X["G"], X["V3"], X["V3"] * 0, X["G"],
        use_global_stats=True)),
    ("npx.cast", lambda np, npx, X: npx.cast(X["A"] * 3, dtype="int32")),
    ("npx.convolution", lambda np, npx, X: npx.convolution(
        X["X4"], X["Wc"], None, kernel=(3, 3), num_filter=4, pad=(1, 1),
        no_bias=True)),
    ("npx.deconvolution", lambda np, npx, X: npx.deconvolution(
        X["X4"], X["Wd"], None, kernel=(3, 3), num_filter=4, pad=(1, 1),
        no_bias=True)),
    ("npx.dropout", lambda np, npx, X: npx.dropout(X["A"], p=0.5)),
    ("npx.embedding", lambda np, npx, X: npx.embedding(
        np.array([[0, 2], [1, 1]], dtype="int32"), X["A"], input_dim=3,
        output_dim=4)),
    ("npx.erf", lambda np, npx, X: npx.erf(X["A"])),
    ("npx.erfinv", lambda np, npx, X: npx.erfinv(X["U"])),
    ("npx.fully_connected", lambda np, npx, X: npx.fully_connected(
        X["A"], X["B"], X["V3"], num_hidden=3)),
    ("npx.gamma", lambda np, npx, X: npx.gamma(X["P"])),
    ("npx.gammaln", lambda np, npx, X: npx.gammaln(X["P"])),
    ("npx.gather_nd", lambda np, npx, X: npx.gather_nd(
        X["A"], np.array([[0, 1, 2], [1, 0, 3]], dtype="int32"))),
    ("npx.layer_norm", lambda np, npx, X: npx.layer_norm(
        X["A"], X["V4"], X["V4"] * 0.5)),
    ("npx.leaky_relu", lambda np, npx, X: npx.leaky_relu(X["A"],
                                                         slope=0.1)),
    ("npx.multibox_prior", lambda np, npx, X: _mbox_prior(npx, X)),
    ("npx.multibox_target", lambda np, npx, X: _mbox_target(np, npx, X)),
    ("npx.multibox_detection", lambda np, npx, X: _mbox_detection(
        np, npx, X)),
    ("npx.one_hot", lambda np, npx, X: npx.one_hot(
        np.array([0, 2, 1], dtype="int32"), 4)),
    ("npx.pick", lambda np, npx, X: npx.pick(
        X["A"], np.array([0, 3, 1], dtype="int32"), axis=1)),
    ("npx.pooling", lambda np, npx, X: npx.pooling(
        X["X4"], kernel=(2, 2), stride=(2, 2), pool_type="max")),
    ("npx.reshape_like", lambda np, npx, X: npx.reshape_like(
        X["A"], np.zeros((4, 3)))),
    ("npx.rnn", lambda np, npx, X: _rnn(np, npx, X)),
    ("npx.roi_pooling", lambda np, npx, X: npx.roi_pooling(
        X["X4"], np.array([[0, 0, 0, 4, 4], [1, 1, 1, 5, 3]]), (2, 2),
        1.0)),
    ("npx.sequence_mask", lambda np, npx, X: npx.sequence_mask(
        X["A3"], np.array([1.0, 2.0, 0.0]), use_sequence_length=True)),
    ("npx.shape_array", lambda np, npx, X: npx.shape_array(X["A3"])),
    ("npx.slice", lambda np, npx, X: npx.slice(X["A"], (0, 1), (2, 3))),
    ("npx.smooth_l1", lambda np, npx, X: npx.smooth_l1(X["A"])),
    ("npx.topk", lambda np, npx, X: npx.topk(X["A"], k=2,
                                             ret_typ="value")),
]

NPX_IMAGE_CASES = [
    ("image.to_tensor", lambda np, npx, X: npx.image.to_tensor(X["Img"])),
    ("image.normalize", lambda np, npx, X: npx.image.normalize(
        npx.image.to_tensor(X["Img"]), (0.5, 0.4, 0.3), (0.2, 0.3, 0.4))),
    ("image.resize", lambda np, npx, X: npx.image.resize(X["Img"], (4, 6))),
    ("image.resize_up", lambda np, npx, X: npx.image.resize(X["Img"],
                                                            (12, 9))),
    ("image.resize_keep", lambda np, npx, X: npx.image.resize(
        X["Img"], 3, keep_ratio=True)),
    ("image.crop", lambda np, npx, X: npx.image.crop(X["Img"], 1, 2, 4, 3)),
    ("image.flip_left_right", lambda np, npx, X:
     npx.image.flip_left_right(X["Img"])),
    ("image.flip_top_bottom", lambda np, npx, X:
     npx.image.flip_top_bottom(X["Img"])),
    ("image.adjust_lighting", lambda np, npx, X: npx.image.adjust_lighting(
        X["Img"], (0.1, -0.2, 0.05))),
    # a random op with a degenerate range is deterministic
    ("image.random_brightness", lambda np, npx, X:
     npx.image.random_brightness(X["Img"], 1.5, 1.5)),
    ("image.random_contrast", lambda np, npx, X:
     npx.image.random_contrast(X["Img"], 0.5, 0.5)),
    ("image.random_saturation", lambda np, npx, X:
     npx.image.random_saturation(X["Img"], 0.3, 0.3)),
    ("image.random_hue", lambda np, npx, X: npx.image.random_hue(
        X["Img"], 0.2, 0.2)),
    ("image.random_color_jitter", lambda np, npx, X:
     npx.image.random_color_jitter(X["Img"], brightness=0.0)),
]

#: random draws: (label, draw(np, npx) -> array of >= 20,000 samples,
#: (mean, variance) of the distribution)
RANDOM_CASES = [
    ("random.uniform", lambda np, npx: np.random.uniform(-1, 3, (20000,)),
     (1.0, 16 / 12)),
    ("random.normal", lambda np, npx: np.random.normal(1, 2, (20000,)),
     (1.0, 4.0)),
    ("random.randint", lambda np, npx: np.random.randint(0, 10, (20000,)),
     (4.5, 99 / 12)),
    ("random.rand", lambda np, npx: np.random.rand(20000), (0.5, 1 / 12)),
    ("random.randn", lambda np, npx: np.random.randn(20000), (0.0, 1.0)),
    ("random.choice", lambda np, npx: np.random.choice(4, (20000,)),
     (1.5, 1.25)),
    ("random.multinomial", lambda np, npx: np.random.multinomial(
        10, [0.2, 0.8], (20000,))[:, 0], (2.0, 1.6)),
    ("random.multivariate_normal", lambda np, npx:
     np.random.multivariate_normal(np.array([1.0, 2.0]),
                                   np.array([[1.0, 0.0], [0.0, 4.0]]),
                                   (20000,))[:, 1], (2.0, 4.0)),
    ("random.logistic", lambda np, npx: np.random.logistic(1, 2, (20000,)),
     (1.0, 4 * onp.pi ** 2 / 3)),
    ("random.gumbel", lambda np, npx: np.random.gumbel(0, 1, (20000,)),
     (0.5772156649, onp.pi ** 2 / 6)),
    ("random.gamma", lambda np, npx: np.random.gamma(2.0, 1.5, (20000,)),
     (3.0, 4.5)),
    ("random.beta", lambda np, npx: np.random.beta(2.0, 3.0, (20000,)),
     (0.4, 0.04)),
    ("random.chisquare", lambda np, npx: np.random.chisquare(3.0,
                                                             (20000,)),
     (3.0, 6.0)),
    ("random.exponential", lambda np, npx: np.random.exponential(
        2.0, (20000,)), (2.0, 4.0)),
    ("random.lognormal", lambda np, npx: np.random.lognormal(
        0.0, 0.5, (20000,)), (onp.exp(0.125), (onp.exp(0.25) - 1)
                              * onp.exp(0.25))),
    ("random.weibull", lambda np, npx: np.random.weibull(2.0, (20000,)),
     (0.8862269, 0.2146018)),
    ("random.pareto", lambda np, npx: np.random.pareto(5.0, (20000,)),
     (0.25, 5 / (16 * 3))),
    ("random.power", lambda np, npx: np.random.power(3.0, (20000,)),
     (0.75, 3 / 80)),
    ("random.rayleigh", lambda np, npx: np.random.rayleigh(1.0, (20000,)),
     (1.2533141, 0.4292037)),
    ("npx.random.normal_n", lambda np, npx: npx.random.normal_n(
        1.0, 2.0, batch_shape=(20000,)), (1.0, 4.0)),
    ("npx.random.uniform_n", lambda np, npx: npx.random.uniform_n(
        0.0, 2.0, batch_shape=(20000,)), (1.0, 1 / 3)),
    ("npx.random.bernoulli", lambda np, npx: npx.random.bernoulli(
        prob=0.3, size=(20000,)), (0.3, 0.21)),
]


def host(r):
    """A case's result as nested lists of numpy arrays and scalars."""
    if hasattr(r, "asnumpy"):
        return onp.asarray(r.asnumpy())
    if isinstance(r, (list, tuple)):
        return [host(x) for x in r]
    if isinstance(r, onp.dtype):
        return str(r)
    return r


def compare(got, want, label, atol=ATOL, rtol=RTOL):
    """Raise AssertionError naming ``label`` unless ``got`` matches
    ``want``: floats within ``atol + rtol·|want|``, ints, bools and
    strings exactly, shapes equal."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (label, "length", got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, "%s[%d]" % (label, i), atol, rtol)
        return
    if isinstance(want, str) or want is None:
        assert got == want, (label, got, want)
        return
    g, w = onp.asarray(got), onp.asarray(want)
    assert g.shape == w.shape, (label, "shape", g.shape, w.shape)
    if w.dtype.kind in "fc" or g.dtype.kind in "fc":
        onp.testing.assert_allclose(g.astype(w.dtype if w.dtype.kind in "fc"
                                             else "float64"), w, rtol=rtol,
                                    atol=atol, equal_nan=True,
                                    err_msg=label)
    else:
        assert g.dtype.kind == w.dtype.kind or {g.dtype.kind, w.dtype.kind} \
            <= {"i", "u"}, (label, "kind", g.dtype, w.dtype)
        onp.testing.assert_array_equal(g, w, err_msg=label)


def moments_ok(sample, mean, var, label):
    """The sample mean within 5 standard errors of ``mean`` and the
    sample variance within 10 % of ``var``."""
    s = onp.asarray(sample, "float64").ravel()
    n = s.size
    m, v = float(s.mean()), float(s.var())
    assert abs(m - mean) <= 5 * (var / n) ** 0.5 + 1e-9, (label, m, mean)
    assert abs(v - var) <= 0.1 * var, (label, v, var)
