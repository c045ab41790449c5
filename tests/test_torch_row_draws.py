"""The port's row-keyed draws (R1/R2, ``ops/cuda/row_draw.py``, through
``parallel.rng``) against ``fastbox_tpu``'s on the same keys.

A port seed s is ``jax.random.PRNGKey(s)`` with 64-bit integers on (as
tests/conftest.py sets them).  The plain twins reproduce jax's threefry
stream, so on the CPU:

* the bits and uniforms of every row are jax's bit for bit (seeds 0,
  1234, 2**32 + 5 and -7, every ``TAGS`` tag, rows from 0 and 13, rows of
  (16, 16), (15, 15), (16,) and (15,), float32 and float64);
* the normals differ from ``fastbox_tpu.parallel.rng.row_normal`` only by
  torch's ``erfinv`` (or ``log``, ``cos``, ``sin``) against XLA's.  Over
  2**22 values (64 rows of (256, 256), seed 77, tag 1) the largest
  difference, in units of the spacing of jax's value, was 91 (float32
  erfinv; 2.2e-5 absolute, in the tails), 14919 (float64 erfinv; 1.3e-11
  absolute: XLA's float64 erf_inv is the looser of the two) and 3
  (Box-Muller, both dtypes).  The bounds below are those rounded up to a
  power of two;
* the Poisson counts of rates below 10 (Knuth's loop: 0, 1e-3 to 9.99,
  NaN) equal ``fastbox_tpu.parallel.halos.row_poisson``'s: 0 of 2**23
  differed.  From 10 (Hörmann's rejection) a draw hangs on ``s <= t``,
  where t = -lam + k log(lam) - lgamma(k + 1) cancels two terms of up to
  ~1e5, so that a one-ulp difference of XLA's ``lgamma``/``log`` (and its
  fused multiply-adds) against torch's decides ~0.2% of the acceptances;
  jax's loop runs a row until every element has been accepted once and
  keeps each element's last accepted k, so one decided acceptance can move
  a whole row.  Measured: 1.6% (rows of 256) and 2.7% (rows of 4096) of
  2**20 counts differed, every other count equal; the bound is 5%, and
  the differing counts keep the distribution (mean within 0.5 sigma).

The batch forms (a list of seeds, a (B, 2) key tensor) equal per-key
calls.  The ``cuda`` cases hold R1/R2 to their twins on a card (bitwise
uniforms and counts; normals within 2 ulp) and skip without one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.parallel.halos import row_poisson as jax_row_poisson
from fastbox_tpu.parallel.rng import TAGS as JAX_TAGS
from fastbox_tpu.parallel.rng import row_normal as jax_row_normal
from fastbox_tpu_torch.ops.cuda import row_draw
from fastbox_tpu_torch.parallel.rng import (TAGS, row_complex_normal,
                                            row_draws, row_keys, row_normal,
                                            row_poisson)
from test_torch_poisson_passes import CASES as POISSON_CASES
from test_torch_poisson_passes import poisson_case

SEEDS = (0, 1234, 2 ** 32 + 5, -7)
SHAPES = ((16, 16), (15, 15), (16,), (15,))
DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NROWS = 3
# normals against fastbox_tpu's: spacings of jax's value (module docstring)
ULP_BOUND = {("erfinv", torch.float32): 128,
             ("erfinv", torch.float64): 2 ** 14,
             ("box_muller", torch.float32): 4,
             ("box_muller", torch.float64): 4}
REJECTION_DIFF_BOUND = 0.05


def spacings(got, want) -> float:
    """max |got - want| over the spacing of |want| in its dtype."""
    want = np.asarray(want)
    sp = np.spacing(np.abs(want)).astype(np.float64)
    return float((np.abs(np.asarray(got, np.float64) - want) / sp).max())


@functools.lru_cache(maxsize=None)
def jax_rows(what: str, shape, dtype=None, method=None):
    """A jitted fastbox_tpu/jax draw of NROWS rows, ``f(key, tag, row0)``:
    'bits32'/'bits64' (jax.random.bits), 'uniform' (the erfinv path's
    uniform) or 'normal' (``row_normal`` with ``method``)."""
    if what == "normal":
        return jax.jit(lambda k, t, r: jax_row_normal(k, t, r, NROWS, shape,
                                                      dtype, method))
    lo = None if dtype is None else np.nextafter(np.array(-1.0, dtype),
                                                 np.array(0.0, dtype))
    draw = {"bits32": lambda k: jax.random.bits(k, shape, jnp.uint32),
            "bits64": lambda k: jax.random.bits(k, shape, jnp.uint64),
            "uniform": lambda k: jax.random.uniform(k, shape, dtype, lo, 1.0)
            }[what]

    def rows(key, tag, row0):
        base = jax.random.fold_in(key, tag)
        return jax.vmap(lambda i: draw(jax.random.fold_in(base, i)))(
            row0 + jnp.arange(NROWS))

    return jax.jit(rows)


def test_seed_words_are_prngkeys():
    for s in SEEDS + (2 ** 63 - 1, -2 ** 63):
        keys, batched = row_keys(s, "cpu")
        assert not batched
        np.testing.assert_array_equal(
            keys[0].numpy(), np.asarray(jax.random.PRNGKey(s), np.int64))
    with pytest.raises(ValueError, match="int64"):
        row_keys(2 ** 63, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("row0", [0, 13])
def test_bits_equal_jax(seed, row0):
    """The 32- and 64-bit words of every row: jax.random.bits."""
    shape = (15, 15)
    count = torch.arange(225, dtype=torch.int64)[None]
    for tag in TAGS.values():
        keys, _ = row_keys(seed, "cpu")
        k0, k1 = row_draw._row_keys(keys, tag, row0, NROWS)
        b0, b1 = row_draw.threefry2x32(k0[:, None], k1[:, None], 0, count)
        key = jax.random.PRNGKey(seed)
        want32 = np.asarray(jax_rows("bits32", shape)(key, tag, row0))
        want64 = np.asarray(jax_rows("bits64", shape)(key, tag, row0))
        np.testing.assert_array_equal((b0 ^ b1).numpy(),
                                      want32.reshape(NROWS, -1))
        got64 = (b0.numpy().astype(np.uint64) << np.uint64(32)) \
            | b1.numpy().astype(np.uint64)
        np.testing.assert_array_equal(got64, want64.reshape(NROWS, -1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("row0", [0, 13])
def test_uniforms_equal_jax(seed, dtype, row0):
    """The erfinv path's uniform on [nextafter(-1, 0), 1), bit for bit,
    for every tag and row shape."""
    for shape in SHAPES:
        f = jax_rows("uniform", shape, DTYPES[dtype])
        for tag in TAGS.values():
            got = row_normal(seed, tag, row0, NROWS, shape, dtype, "cpu",
                             method="uniform")
            want = f(jax.random.PRNGKey(seed), tag, row0)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["erfinv", "box_muller"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_normals_match_fastbox_tpu(method, dtype, seed):
    bound = ULP_BOUND[method, dtype]
    assert TAGS == JAX_TAGS
    for shape in SHAPES:
        f = jax_rows("normal", shape, DTYPES[dtype], method)
        for row0 in (0, 13):
            for name, tag in TAGS.items():
                got = row_normal(seed, tag, row0, NROWS, shape, dtype, "cpu",
                                 method=method)
                want = f(jax.random.PRNGKey(seed), tag, row0)
                assert got.shape == (NROWS, *shape)
                err = spacings(got.numpy(), want)
                assert err <= bound, (name, shape, row0, err)


@pytest.mark.parametrize("method", ["erfinv", "box_muller"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_normal_bound_over_2_22_values(method, dtype):
    """The measurement behind ULP_BOUND: 64 rows of (256, 256)."""
    got = row_normal(77, TAGS["density"], 0, 64, (256, 256), dtype, "cpu",
                     method=method)
    want = jax_row_normal(jax.random.PRNGKey(77), TAGS["density"], 0, 64,
                          (256, 256), DTYPES[dtype], method)
    assert got.numel() == 2 ** 22
    assert spacings(got.numpy(), want) <= ULP_BOUND[method, dtype]
    assert abs(got.mean().item()) < 5 / 2 ** 11
    assert abs(got.std().item() - 1) < 5 / 2 ** 11


def rates(kind: str, shape, seed: int = 0) -> np.ndarray:
    """Knuth's rates (0, 1e-3..9.99, NaN) or the rejection's (10..1e4)."""
    rng = np.random.default_rng(seed)
    if kind == "rejection":
        return rng.uniform(10.0, 1e4, shape)
    lam = rng.uniform(1e-3, 9.99, shape)
    lam.reshape(-1)[::17] = 0.0
    lam.reshape(-1)[5::97] = np.nan
    return lam


@pytest.mark.parametrize("seed", [0, 2 ** 32 + 5, -7])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poisson_knuth_counts_equal_fastbox_tpu(seed, dtype):
    lam = torch.as_tensor(rates("knuth", (8, 16, 16)), dtype=dtype)
    got = row_poisson(seed, TAGS["halos"], 5, lam)
    want = np.asarray(jax_row_poisson(jax.random.PRNGKey(seed), TAGS["halos"],
                                      5, jnp.asarray(lam.numpy())))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want.astype(lam.numpy().dtype))
    assert (got[lam == 0] == 0).all() and (got[lam.isnan()] == -1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("row_len", [256, 4096])
def test_poisson_rejection_counts_follow_fastbox_tpu(dtype, row_len):
    """Equal but where a rounding of lgamma/log decides an acceptance (the
    module docstring): at most 5% of 2**18 counts differ."""
    lam = torch.as_tensor(rates("rejection", (2 ** 18 // row_len, row_len)),
                          dtype=dtype)
    got = row_poisson(3, TAGS["halos"], 0, lam).numpy()
    want = np.asarray(jax_row_poisson(jax.random.PRNGKey(3), TAGS["halos"], 0,
                                      jnp.asarray(lam.numpy())))
    differ = got != want
    assert differ.mean() <= REJECTION_DIFF_BOUND, differ.mean()
    lam = lam.numpy().astype(np.float32).astype(np.float64)
    z = (got - lam) / np.sqrt(lam)
    assert abs(z.mean()) * np.sqrt(z.size) < 5 and abs(z.std() - 1) < 0.02
    gap = (got[differ] - want[differ]) / np.sqrt(lam[differ])
    assert abs(gap.mean()) < 0.5, gap.mean()


def test_poisson_mixed_row_equals_fastbox_tpu():
    """A row whose rates are all below 10 but one: the Knuth counts are
    jax's whatever the rejection element's loop does."""
    lam = rates("knuth", (4, 64))
    lam[:, 7] = 50.0
    got = row_poisson(11, TAGS["halos"], 0, torch.as_tensor(lam)).numpy()
    want = np.asarray(jax_row_poisson(jax.random.PRNGKey(11), TAGS["halos"],
                                      0, jnp.asarray(lam)))
    keep = np.ones(lam.shape, bool)
    keep[:, 7] = False
    np.testing.assert_array_equal(got[keep], want[keep])


def test_batch_of_seeds_equals_per_seed_calls():
    seeds = [3, 2 ** 32 + 5, -7]
    for method in ("erfinv", "box_muller"):
        batch = row_normal(seeds, TAGS["noise"], 4, 5, (8, 6), torch.float64,
                           "cpu", method=method)
        assert batch.shape == (3, 5, 8, 6)
        for b, s in enumerate(seeds):
            assert torch.equal(batch[b], row_normal(
                s, TAGS["noise"], 4, 5, (8, 6), torch.float64, "cpu",
                method=method))
    tensor_seeds = row_normal(torch.tensor(seeds), TAGS["noise"], 4, 5, (8,),
                              torch.float32, "cpu")
    assert torch.equal(tensor_seeds, row_normal(seeds, TAGS["noise"], 4, 5,
                                                (8,), torch.float32, "cpu"))
    lam = torch.as_tensor(rates("knuth", (3, 4, 8)))
    counts = row_poisson(seeds, TAGS["halos"], 2, lam)
    for b, s in enumerate(seeds):
        assert torch.equal(counts[b], row_poisson(s, TAGS["halos"], 2, lam[b]))
    fields = row_draws(seeds, ("density", "fg_re"), 6, dtype=torch.float64,
                       device="cpu")
    assert fields["density"].shape == (3, 6, 6, 6)
    assert fields["fg_re"].shape == (3, 6, 6)
    c = row_complex_normal(seeds, TAGS["fg_re"], TAGS["fg_im"], 0, 6, (6,),
                           torch.float64, "cpu")
    assert torch.equal(c.real, fields["fg_re"])


def test_key_tensor_equals_seeds_and_raw_jax_keys():
    seeds = [0, 1234, 2 ** 32 + 5, -7]
    words = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])
    for keys in (torch.as_tensor(words.astype(np.int64)),
                 torch.as_tensor(words.view(np.int32))):
        assert torch.equal(
            row_normal(keys, TAGS["alpha"], 0, 4, (16,), torch.float32, "cpu"),
            row_normal(seeds, TAGS["alpha"], 0, 4, (16,), torch.float32,
                       "cpu"))
    raw = jax.random.split(jax.random.PRNGKey(5), 2)
    got = row_normal(torch.as_tensor(np.asarray(raw).astype(np.int64)),
                     TAGS["density"], 2, 4, (16, 16), torch.float64, "cpu")
    for b in range(2):
        want = jax_row_normal(raw[b], TAGS["density"], 2, 4, (16, 16),
                              jnp.float64)
        assert spacings(got[b].numpy(), want) <= ULP_BOUND["erfinv",
                                                           torch.float64]


def test_out_and_checks():
    out = torch.full((2, 4, 8), torch.nan, dtype=torch.float64)
    got = row_normal([1, 2], TAGS["noise"], 0, 4, (8,), out=out)
    assert got.data_ptr() == out.data_ptr() and not out.isnan().any()
    one = torch.empty((4, 8))
    assert row_normal(1, TAGS["noise"], 0, 4, (8,), out=one) is one
    assert torch.equal(one, row_normal(1, TAGS["noise"], 0, 4, (8,),
                                       torch.float32, "cpu"))
    with pytest.raises(ValueError, match="Unknown row_normal method"):
        row_normal(1, 1, 0, 2, (4,), device="cpu", method="polar")
    with pytest.raises(ValueError, match="out must be"):
        row_normal(1, 1, 0, 2, (4,), out=torch.empty((2, 5)))
    with pytest.raises(TypeError, match="unsupported dtype"):
        row_normal(1, 1, 0, 2, (4,), torch.float16, "cpu")
    with pytest.raises(ValueError, match="lam must be"):
        row_draw.row_poisson_plain(row_keys([1, 2], "cpu")[0], 1, 0,
                                   torch.ones((3, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        row_draw.row_normal_cuda(row_keys(1, "cpu")[0], 1, 0, 2, (4,))
    with pytest.raises(ValueError, match="CUDA"):
        row_draw.row_poisson_cuda(row_keys(1, "cpu")[0], 1, 0,
                                  torch.ones((1, 2, 4)))


def test_vector_path_rule():
    f32 = torch.empty((2, 16))
    assert row_draw.vector_path("erfinv", (16,), f32)
    assert not row_draw.vector_path("erfinv", (15,), f32)
    assert not row_draw.vector_path("erfinv", (16,), f32.view(-1)[1:17])
    assert row_draw.vector_path("box_muller", (8, 16), f32)
    assert not row_draw.vector_path("box_muller", (2, 12), f32)
    assert row_draw.vector_path("box_muller", (2, 12), torch.empty(
        (2, 12), dtype=torch.float64))
    assert not row_draw.vector_path("box_muller", (15,), f32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def ulps(a, b) -> int:
    """Largest distance in representable values between a and b (of one
    sign, as two draws of the same value are)."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return int((a.view(it).long() - b.view(it).long()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["uniform", "erfinv", "box_muller"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("row_shape", [(64, 64), (63, 63), (64,), (63,)])
def test_kernel_equals_twin(cuda, method, dtype, row_shape):
    keys, _ = row_keys([0, 2 ** 32 + 5, -7], cuda)
    got = row_draw.row_normal_cuda(keys, TAGS["noise"], 100, 5, row_shape,
                                   dtype, method)
    want = row_draw.row_normal_plain(keys, TAGS["noise"], 100, 5, row_shape,
                                     dtype, method)
    if method == "uniform":
        assert torch.equal(got, want)
    else:
        assert ulps(got, want) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("mixed rows",) + POISSON_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poisson_kernel_equals_twin(cuda, dtype, case):
    """Rows of Knuth and of rejection rates, and the pass emulation's cases
    (tests/test_torch_poisson_passes.py) on one key and three."""
    if case == "mixed rows":
        lam = np.concatenate([rates("knuth", (4, 512)),
                              rates("rejection", (4, 512))])
        lam = torch.as_tensor(lam, dtype=dtype, device=cuda)[None]
    else:
        lam = poisson_case(case, (3, 4, 100), dtype).to(cuda)
    keys, _ = row_keys([9, 2 ** 32 + 5, -7][:lam.shape[0]], cuda)
    got = row_draw.row_poisson_cuda(keys, TAGS["halos"], 0, lam)
    want = row_draw.row_poisson_plain(keys, TAGS["halos"], 0, lam)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
