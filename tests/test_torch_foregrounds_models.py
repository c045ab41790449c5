"""The port's foreground models (``models/foregrounds.py``) against
fastbox_tpu's, in float64 on the CPU.

``ForegroundModel``'s reference methods and ``PointSourceModel`` run on the
noise fastbox_tpu draws (supplied as ``white=``/``normals=``/
``white_clustering=``/...): rtol 1e-10 of the largest value, the flux-count
functions and the mean temperature exactly, the bright-source shot map bit
for bit.  ``PlanckSkyModel`` runs both packages through the same stub
healpy (a copy of tests/test_models.py's): the host maps bit for bit, the
cube to rtol 1e-12.  The GSM and Planck models raise ImportError without
pygdsm / healpy in both packages.
"""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.box import CosmoBox as JaxBox
from fastbox_tpu.models import foregrounds as jfg
from fastbox_tpu_torch.box import CosmoBox, default_cosmo
from fastbox_tpu_torch.models import foregrounds as tfg

RTOL = 1e-10


def boxes(n=16, z=0.8, seed=3, box=1e3):
    """(fastbox_tpu's box, the port's box) of one geometry, float64."""
    kw = dict(cosmo=default_cosmo, box_scale=(box,) * 3, nsamp=n, redshift=z,
              realise_now=False, seed=seed)
    return JaxBox(**kw), CosmoBox(dtype=torch.float64, device="cpu", **kw)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def next_key(jb):
    """The key ``jb``'s next draw takes, leaving ``jb`` where it was."""
    saved = jb._key
    key = jb.next_key()
    jb._key = saved
    return key


def test_complex_white_noise():
    gen = torch.Generator().manual_seed(5)
    w = tfg.complex_white_noise(gen, (64, 64), torch.float64, "cpu")
    assert w.shape == (64, 64) and w.dtype == torch.complex128
    again = tfg.complex_white_noise(torch.Generator().manual_seed(5),
                                    (64, 64), torch.float64, "cpu")
    assert torch.equal(w, again)
    for part in (w.real, w.imag):
        assert abs(part.mean().item()) < 0.1
        assert abs(part.std().item() - 1.0) < 0.1
    w32 = tfg.complex_white_noise(gen, (4, 4))
    assert w32.dtype == torch.complex64


@pytest.mark.parametrize("smoothing", (None, 4.0))
def test_foreground_amp_on_supplied_noise(smoothing):
    jb, tb = boxes(n=32)
    white = np.array(jfg.complex_white_noise(next_key(jb), (32, 32),
                                             jnp.float64))
    want = jfg.ForegroundModel(jb).realise_foreground_amp(
        57.0, 1.1, 10.0, smoothing_scale=smoothing)
    got = tfg.ForegroundModel(tb).realise_foreground_amp(
        57.0, 1.1, 10.0, smoothing_scale=smoothing,
        white=torch.as_tensor(white))
    assert got.dtype == torch.float64
    close(got, want)


def test_spectral_index_and_cube_on_supplied_noise():
    jb, tb = boxes(n=32)
    normals = np.array(jax.random.normal(next_key(jb), (32, 32),
                                         jnp.float64))
    jf, tf = jfg.ForegroundModel(jb), tfg.ForegroundModel(tb)
    alpha_j = jf.realise_spectral_index(2.07, 2e-4, 15.0)
    alpha_t = tf.realise_spectral_index(2.07, 2e-4, 15.0,
                                        normals=torch.as_tensor(normals))
    close(alpha_t, alpha_j)
    amps = np.random.default_rng(1).standard_normal((32, 32)) + 10.0
    close(tf.construct_cube(torch.as_tensor(amps), alpha_t, freq_ref=130.0),
          jf.construct_cube(jnp.asarray(amps), alpha_j, freq_ref=130.0))
    close(tf.construct_cube(torch.as_tensor(amps), 2.5),
          jf.construct_cube(jnp.asarray(amps), 2.5))


def test_foreground_model_draws_from_the_box():
    """The box's generator feeds the draws (tests/test_models.py:87-113)."""
    _, tb = boxes(n=32)
    fg = tfg.ForegroundModel(tb)
    amp_map = fg.realise_foreground_amp(57.0, 1.1, 10.0)
    assert amp_map.shape == (32, 32)
    assert np.isclose(amp_map.mean().item(), 10.0, atol=2.0)
    alpha = fg.realise_spectral_index(2.07, 2e-4, 15.0)
    assert np.isclose(alpha.mean().item(), 2.07, atol=1e-3)
    cube = fg.construct_cube(amp_map, alpha, freq_ref=130.0)
    freqs = tb.freq_array()
    close(cube[:, :, 5], amp_map * (freqs[5] / 130.0) ** alpha)
    tb.set_seed(3)
    assert torch.equal(fg.realise_foreground_amp(57.0, 1.1, 10.0), amp_map)


class _Recorder:
    """jax.numpy with ``asarray``'s numpy arguments kept, in call order."""

    def __init__(self, mod):
        self._mod = mod
        self.arrays = []

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def asarray(self, a, *args, **kw):
        if isinstance(a, np.ndarray):
            self.arrays.append(a.copy())
        return self._mod.asarray(a, *args, **kw)


def test_point_sources_on_supplied_noise(monkeypatch):
    """fastbox_tpu's clustering and Poisson GRFs come from PRNGKey(1) and
    PRNGKey(2), its spectral indices from the box's next key; the port is
    given the same numbers.  The shot map (the third numpy map fastbox_tpu
    hands to jnp.asarray, after the two C_ell grids) is bitwise equal."""
    jb, tb = boxes(n=32, box=2e3)
    n = 32
    wc = np.array(jfg.complex_white_noise(jax.random.PRNGKey(1), (n, n),
                                          jnp.float64))
    wp = np.array(jfg.complex_white_noise(jax.random.PRNGKey(2), (n, n),
                                          jnp.float64))
    normals = np.array(jax.random.normal(next_key(jb), (n, n), jnp.float64))
    rec = _Recorder(jfg.jnp)
    monkeypatch.setattr(jfg, "jnp", rec)
    kw = dict(flux_cutoff=0.1, beta=-2.7, delta_beta=0.1, seed_clustering=1,
              seed_poisson=2)
    cube_j, tmean_j = jfg.PointSourceModel(jb).construct_cube(**kw)
    monkeypatch.undo()
    ps = tfg.PointSourceModel(tb)
    cube_t, tmean_t = ps.construct_cube(
        **kw, white_clustering=torch.as_tensor(wc),
        white_poisson=torch.as_tensor(wp),
        spidx_normals=torch.as_tensor(normals))
    assert cube_t.shape == (n, n, n) and cube_t.dtype == torch.float64
    close(cube_t, cube_j)
    np.testing.assert_array_equal(tmean_t, tmean_j)
    shot_j = rec.arrays[2]
    shot_t = ps.shot_map(0.1, seed_poisson=2)
    assert shot_j.shape == (n, n) and shot_t.any()
    np.testing.assert_array_equal(shot_t, shot_j)
    assert not ps.shot_map(0.01, seed_poisson=2).any()
    for s in (0.05, 0.3, 2.0):
        for name in ("flux_amplitude", "integ_flux", "poisson_pspec",
                     "number_count"):
            assert getattr(ps, name)(s) == getattr(
                jfg.PointSourceModel(jb), name)(s)


def test_point_sources_seeded_and_from_the_box():
    """Seeds make the GRFs repeat; without seeds the box's generator
    draws (tests/test_models.py:116-131)."""
    _, tb = boxes(n=16)
    ps = tfg.PointSourceModel(tb)
    kw = dict(flux_cutoff=0.1, beta=-2.7, delta_beta=0.1, seed_clustering=1,
              seed_poisson=2)
    a, tmean = ps.construct_cube(**kw)
    tb.set_seed(3)
    b, _ = ps.construct_cube(**kw)
    assert torch.equal(a, b)
    assert a.shape == (16, 16, 16) and torch.isfinite(a).all()
    assert tmean.shape == (16, 1) and (tmean > 0).all()
    c, _ = ps.construct_cube(0.1, -2.7, 0.1)
    assert torch.isfinite(c).all() and not torch.equal(a, c)


def _healpy_stub(nside, rng):
    """Minimal fake healpy exposing what PlanckSkyModel touches (a copy of
    tests/test_models.py:298-328)."""
    npix = 12 * nside**2
    maps = {
        "ff217": 1.0 + rng.random(npix),
        "sync217": 5.0 + rng.random(npix),
        "sync353": 2.0 + rng.random(npix),
    }
    calls = {"gnomview": []}
    hp = types.ModuleType("healpy")
    hp._maps = maps
    hp._calls = calls
    hp.get_nside = lambda m: int(np.sqrt(m.size / 12))
    resol_arcmin = np.degrees(np.sqrt(4.0 * np.pi / npix)) * 60.0
    hp.nside2resol = lambda ns, arcmin=False: (
        resol_arcmin if arcmin else np.radians(resol_arcmin / 60.0))

    hp.fitsfunc = types.SimpleNamespace(
        read_map=lambda path, field=0, nest=False: maps[path])
    hp.sphtfunc = types.SimpleNamespace(
        synfast=lambda cls, ns: np.zeros(12 * ns**2))

    def gnomview(m, **kw):
        calls["gnomview"].append(kw)
        xs, ys = kw["xsize"], kw["ysize"]
        return m[: xs * ys].reshape(ys, xs)

    hp.visufunc = types.SimpleNamespace(gnomview=gnomview)
    return hp


def test_planck_sky_model_through_stub_healpy(rng, monkeypatch):
    hp = _healpy_stub(nside=8, rng=rng)
    monkeypatch.setitem(sys.modules, "healpy", hp)
    jb, tb = boxes(n=8)
    paths = {"ff217": "ff217", "sync217": "sync217", "sync353": "sync353"}
    pj = jfg.PlanckSkyModel(jb, planck_sim_paths=paths)
    pt = tfg.PlanckSkyModel(tb, planck_sim_paths=paths)
    for a, b in zip(pt.read_planck_sim_maps(), pj.read_planck_sim_maps()):
        np.testing.assert_array_equal(a, b)
    maps_t = pt.synch_freefree_maps(seed_syncidx=0)
    maps_j = pj.synch_freefree_maps(seed_syncidx=0)
    for a, b in zip(maps_t, maps_j):
        assert a.shape == (8, 8)
        np.testing.assert_array_equal(a, b)
    assert hp._calls["gnomview"][0]["rot"] == (0.0, -62.0, 0.0)
    cube_t = pt.construct_cube(seed_syncidx=0)
    cube_j = pj.construct_cube(seed_syncidx=0)
    assert cube_t.shape == (8, 8, 8) and cube_t.dtype == torch.float64
    close(cube_t, cube_j, rtol=1e-12)
    assert (cube_t > 0).all()
    for ghz in (100.0, 217.0, 353.0):
        assert pt.planck_corr(ghz) == pj.planck_corr(ghz)
    freqs = tb.freq_array()
    args = [np.abs(rng.standard_normal((8, 8))) + 1.0 for _ in range(2)]
    sidx = -3.0 + 0.1 * rng.standard_normal((8, 8))
    close(tfg.PlanckSkyModel.assemble_cube(
        *(torch.as_tensor(a) for a in args + [sidx]), freqs, 1000.0, -2.1),
        jfg.PlanckSkyModel.assemble_cube(
        *(jnp.asarray(a) for a in args + [sidx]), jnp.asarray(freqs), 1000.0,
        -2.1), rtol=1e-12)


@pytest.mark.parametrize("module", ("healpy", "pygdsm"))
def test_sky_models_need_their_packages(monkeypatch, module):
    """Without pygdsm the GSM raises ImportError in both packages, and the
    Planck model without healpy; nothing falls back."""
    monkeypatch.setitem(sys.modules, module, None)
    jb, tb = boxes(n=8)
    cls = "GlobalSkyModel" if module == "pygdsm" else "PlanckSkyModel"
    for mod, box in ((jfg, jb), (tfg, tb)):
        with pytest.raises(ImportError, match=f"{module} is not installed"):
            getattr(mod, cls)(box)


def test_readme_quickstart_runs_on_the_cpu():
    """The README's port quickstart, at 32^3 on the CPU."""
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1] / "README.md").read_text()
    head = "The quickstart above, in the port, on the card:"
    block = text[text.index(head):].split("```python\n", 1)[1]
    code = block.split("```", 1)[0]
    assert 'device="cuda"' in code and "nsamp=128" in code
    code = code.replace('device="cuda"', 'device="cpu"').replace(
        "nsamp=128", "nsamp=32")
    scope = {}
    exec(compile(code, "README.md", "exec"), scope)
    pk, cleaned = scope["pk"], scope["cleaned"]
    assert cleaned.shape == (32, 32, 32) and torch.isfinite(cleaned).all()
    assert torch.isfinite(pk[1:]).any()
