"""The port's key primitives (``fastbox_tpu_torch.keys``) and the
whole-array draws under them (R1w/R2w, ``ops/cuda/row_draw.py``'s
``key_normal_*``/``key_poisson_*``) against ``jax.random`` on the CPU.

A port seed s is ``jax.random.PRNGKey(s)`` with 64-bit integers on (as
tests/conftest.py sets them).  On the CPU the plain twins run, and:

* ``PRNGKey``, ``split`` and ``fold_in`` give jax's key words;
* the whole-array bits and uniforms equal jax's bit for bit, float32 and
  float64, ``minval``/``maxval`` included: XLA's CPU backend fuses the
  uniform's scale and shift into one multiply-add, and the twins do too
  (on [-3, 3) a product and an add rounded apart differ from jax in ~17%
  of float32 and ~2% of float64 values);
* the normals ('erfinv', and ``_complex_normal``'s two streams) differ only
  by the libraries' erfinv (log, cos, sin): within the spacings
  tests/test_torch_row_draws.py measured over 2**22 row draws (128 f32 /
  2**14 f64 for erfinv, 4 for Box-Muller);
* the Poisson counts of a whole field equal jax's below rate 10 (Knuth's
  loop); from rate 10 a rounding of lgamma/log decides some acceptances,
  and the loop runs over the whole field until every element has been
  accepted once, so one decided acceptance can move the field's step
  count: on a field of rejection rates at most 5% of the counts differ
  (the row draws' bound, tests/test_torch_row_draws.py); in a field that
  mixes both, the Knuth elements run the rejection loop at rate 1e5,
  whose acceptances the roundings decide often, and the rejection counts
  follow jax's only in distribution (test_poisson_mixed_field_knuth_counts_equal_jax);
* ``randint`` equals ``jax.random.randint`` with 64-bit integers.

The ``cuda`` cases hold R1w and R2w to their twins on a card (uniforms and
counts bitwise, normals 0 ulp) and skip without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.fields.gaussian import _complex_normal as jax_complex_normal
from fastbox_tpu_torch import keys
from fastbox_tpu_torch.ops.cuda import row_draw
from test_torch_poisson_passes import CASES as POISSON_CASES
from test_torch_poisson_passes import poisson_case
from test_torch_row_draws import (REJECTION_DIFF_BOUND, ULP_BOUND, rates,
                                  spacings, ulps)

SEEDS = (0, 1234, 2 ** 32 + 5, -7)
DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}
SHAPES = ((3, 5, 7), (33,), (16, 16), ())
SPANS = ((0.0, 1.0), (-3.0, 3.0), (0.0, 1.0 - 1e-8), (0.5, 2.5))


def jkey(seed):
    return jax.random.PRNGKey(seed)


def test_prngkey_split_fold_in_equal_jax():
    for s in SEEDS + (2 ** 63 - 1, -2 ** 63):
        np.testing.assert_array_equal(keys.PRNGKey(s).numpy(),
                                      np.asarray(jkey(s), np.int64))
        for num in (2, 3, 5):
            np.testing.assert_array_equal(
                keys.split(s, num).numpy(),
                np.asarray(jax.random.split(jkey(s), num), np.int64))
        for d in (0, 17, 2 ** 32 - 1):
            np.testing.assert_array_equal(
                keys.fold_in(s, d).numpy(),
                np.asarray(jax.random.fold_in(jkey(s), d), np.int64))
    with pytest.raises(ValueError, match="int64"):
        keys.PRNGKey(2 ** 63)


def test_key_forms_draw_the_same():
    """A seed, its (2,) words as a tensor or a uint32 array, and a row of
    a (B, 2) batch draw one field; the batch adds a leading axis."""
    words = keys.PRNGKey(2 ** 32 + 5)
    want = keys.normal(2 ** 32 + 5, (4, 6), torch.float32, "cpu")
    for k in (words, words.numpy().astype(np.uint32),
              np.asarray(jkey(2 ** 32 + 5))):
        assert torch.equal(keys.normal(k, (4, 6), torch.float32, "cpu"),
                           want)
    batch = torch.stack([keys.PRNGKey(3), words])
    got = keys.normal(batch, (4, 6), torch.float32, "cpu")
    assert got.shape == (2, 4, 6) and torch.equal(got[1], want)
    assert keys.is_key(3) and keys.is_key(words) and keys.is_key(batch)
    assert not keys.is_key(torch.Generator()) and not keys.is_key(None)
    assert not keys.is_key(True) and not keys.is_key(torch.zeros(2))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal_jax(seed):
    """The whole-array counters: element i hashes (0, i) under the key."""
    n = 105
    k0, k1 = keys.PRNGKey(seed).tolist()
    b0, b1 = row_draw.threefry2x32(k0, k1, 0,
                                   torch.arange(n, dtype=torch.int64))
    np.testing.assert_array_equal(
        (b0 ^ b1).numpy(), np.asarray(jax.random.bits(jkey(seed), (n,),
                                                      jnp.uint32)))
    got64 = (b0.numpy().astype(np.uint64) << np.uint64(32)) \
        | b1.numpy().astype(np.uint64)
    np.testing.assert_array_equal(got64, np.asarray(
        jax.random.bits(jkey(seed), (n,), jnp.uint64)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_uniforms_equal_jax(seed, dtype):
    for shape in SHAPES:
        for lo, hi in SPANS:
            got = keys.uniform(seed, shape, dtype, lo, hi, device="cpu")
            want = jax.random.uniform(jkey(seed), shape, DTYPES[dtype], lo, hi)
            assert got.shape == shape and got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uniform_span_is_fused():
    """On [-3, 3) the fused and the separately rounded forms differ, and
    jax's is the fused one."""
    f = keys.uniform(9, (4096,), torch.float32, device="cpu").numpy()
    sep = np.maximum(np.float32(-3), f * np.float32(6) + np.float32(-3))
    want = np.asarray(jax.random.uniform(jkey(9), (4096,), jnp.float32,
                                         -3.0, 3.0))
    assert (sep != want).mean() > 0.05
    np.testing.assert_array_equal(
        keys.uniform(9, (4096,), torch.float32, -3.0, 3.0, "cpu").numpy(),
        want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_normals_within_spacings(seed, dtype):
    bound = ULP_BOUND["erfinv", dtype]
    for shape in SHAPES:
        got = keys.normal(seed, shape, dtype, "cpu")
        want = jax.random.normal(jkey(seed), shape, DTYPES[dtype])
        assert got.shape == shape
        if got.numel():
            assert spacings(got.numpy(), want) <= bound


@pytest.mark.parametrize("method", ["erfinv", "box_muller"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_complex_normal_is_fastbox_tpus(method, dtype):
    """``_complex_normal``'s two streams: split, then two normals or
    bm_pair's (cos, sin) over the whole shape."""
    for seed in SEEDS:
        for shape in ((16, 16, 9), (15,), (4, 7)):
            got = keys.complex_normal(seed, shape, dtype, method, "cpu")
            want = np.asarray(jax_complex_normal(jkey(seed), shape,
                                                 DTYPES[dtype], method))
            assert got.shape == shape and got.dtype == (
                torch.complex64 if dtype == torch.float32
                else torch.complex128)
            for part in ("real", "imag"):
                assert spacings(getattr(got, part).numpy(),
                                getattr(want, part)) <= \
                    ULP_BOUND[method, dtype], (seed, shape, part)


def test_complex_normal_bound_over_2_20_values():
    """Both streams over a 64 x 128 x 128 field in float32."""
    for method in ("erfinv", "box_muller"):
        got = keys.complex_normal(77, (64, 128, 128), torch.float32, method,
                                  "cpu")
        want = np.asarray(jax_complex_normal(jkey(77), (64, 128, 128),
                                             jnp.float32, method))
        for part in ("real", "imag"):
            assert spacings(getattr(got, part).numpy(),
                            getattr(want, part)) <= \
                ULP_BOUND[method, torch.float32]
        assert abs(got.real.mean().item()) < 5 / 2 ** 10


@pytest.mark.parametrize("seed", [0, 2 ** 32 + 5, -7])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poisson_knuth_counts_equal_jax(seed, dtype):
    lam = torch.as_tensor(rates("knuth", (16, 16, 16)), dtype=dtype)
    got = keys.poisson(seed, lam)
    want = np.asarray(jax.random.poisson(jkey(seed), jnp.asarray(
        lam.numpy())))
    assert got.dtype == dtype and got.shape == lam.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))
    assert (got[lam == 0] == 0).all() and (got[lam.isnan()] == -1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poisson_whole_field_rejection_follows_jax(dtype):
    """A 32^3 field of rates 10 to 1e4: at most 5% of the counts differ
    from jax's (0.2% measured), and those keep the distribution."""
    lam = torch.as_tensor(rates("rejection", (32, 32, 32), seed=2),
                          dtype=dtype)
    got = keys.poisson(3, lam).numpy()
    want = np.asarray(jax.random.poisson(jkey(3), jnp.asarray(lam.numpy())))
    differ = got != want
    assert differ.mean() <= REJECTION_DIFF_BOUND, differ.mean()
    assert_poisson(got, lam)
    gap = (got[differ] - want[differ]) / np.sqrt(
        lam.numpy()[differ].astype(np.float64))
    assert abs(gap.mean()) < 0.5, gap.mean()


def assert_poisson(counts, lam):
    lam = lam.numpy().astype(np.float32).astype(np.float64)
    z = (counts - lam) / np.sqrt(lam)
    assert abs(z.mean()) * np.sqrt(z.size) < 5 and abs(z.std() - 1) < 0.02


def test_poisson_mixed_field_knuth_counts_equal_jax():
    """Half Knuth rates, half rejection rates in one 32^3 field.  The Knuth
    counts equal jax's.  The rejection loop runs every element, a Knuth
    element at rate 1e5, where t = -lam + k log(lam) - lgamma(k + 1)
    cancels terms of ~1e6 in float32, so that the libraries' roundings
    decide many of those acceptances and with them the field's step count;
    each rejection element keeps the k of its last accepted step, so when
    the step counts differ most rejection counts do (88% here).  They stay
    Poisson draws of their rates."""
    knuth = rates("knuth", (16, 32, 32), seed=1)
    lam = torch.as_tensor(np.concatenate(
        [knuth, rates("rejection", (16, 32, 32), seed=2)]),
        dtype=torch.float32)
    got = keys.poisson(3, lam).numpy()
    want = np.asarray(jax.random.poisson(jkey(3), jnp.asarray(lam.numpy())))
    np.testing.assert_array_equal(got[:16], want[:16].astype(got.dtype))
    assert_poisson(got[16:], lam[16:])


def test_poisson_batch_equals_per_key_calls():
    lam = torch.as_tensor(np.stack([rates("knuth", (8, 8), seed=4),
                                    rates("rejection", (8, 8), seed=5)]))
    batch = torch.stack([keys.PRNGKey(1), keys.PRNGKey(2 ** 40 + 3)])
    got = keys.poisson(batch, lam)
    for b, s in enumerate((1, 2 ** 40 + 3)):
        assert torch.equal(got[b].nan_to_num(), keys.poisson(
            s, lam[b]).nan_to_num())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equals_jax(seed):
    assert int(keys.randint(seed)) == int(
        jax.random.randint(jkey(seed), (), 0, 2 ** 31 - 1))
    np.testing.assert_array_equal(
        keys.randint(seed, (5, 3), -5, 17).numpy(),
        np.asarray(jax.random.randint(jkey(seed), (5, 3), -5, 17)))


def test_key_vector_path_rule():
    f32 = torch.empty(64, dtype=torch.float32)
    assert row_draw.key_vector_path(64, False, f32)
    assert not row_draw.key_vector_path(63, False, f32)
    assert row_draw.key_vector_path(32, True, f32)
    assert not row_draw.key_vector_path(31, True, f32)
    assert row_draw.key_vector_path(31, True, torch.empty(
        (31, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="pair=True"):
        row_draw.key_normal_plain(keys.PRNGKey(0)[None], 8,
                                  method="box_muller")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method, pair", [
    ("uniform", False), ("erfinv", False), ("uniform", True),
    ("erfinv", True), ("box_muller", True)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [4096, 4095])
def test_key_kernel_equals_twin(cuda, method, pair, dtype, n):
    kw = dict(minval=-3.0, maxval=3.0) if method == "uniform" else {}
    k = torch.stack([keys.PRNGKey(s) for s in (0, 2 ** 32 + 5, -7)]).to(cuda)
    got = row_draw.key_normal_cuda(k, n, dtype, method, pair, **kw)
    want = row_draw.key_normal_plain(k, n, dtype, method, pair, **kw)
    if method == "uniform":
        assert torch.equal(got, want)
    else:
        assert ulps(got, want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("mixed field",) + POISSON_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_key_poisson_kernel_equals_twin(cuda, dtype, case):
    """A field of Knuth and rejection rates, and the pass emulation's
    cases (tests/test_torch_poisson_passes.py) on three keys."""
    if case == "mixed field":
        lam = np.concatenate([rates("knuth", (4, 512)),
                              rates("rejection", (4, 512))])
        lam = torch.as_tensor(lam, dtype=dtype, device=cuda)[None]
    else:
        lam = poisson_case(case, (3, 4, 100), dtype).to(cuda)
    k = torch.stack([keys.PRNGKey(s) for s in (9, 2 ** 32 + 5, -7)
                     ][:lam.shape[0]]).to(cuda)
    got = row_draw.key_poisson_cuda(k, lam)
    want = row_draw.key_poisson_plain(k, lam)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
