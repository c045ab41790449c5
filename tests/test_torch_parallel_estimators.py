"""The port's sharded estimators, PCA filter and halo counts
(``parallel/{spectra,filters,halos}.py``) on gloo ranks.

As tests/test_parallel_{spectra,filters,halos}.py do for fastbox_tpu: on 2
and 4 ranks ('space' = the world, ``parallel.local``) and on a one-rank
mesh in this process, the sharded spectra equal the port's single-device
estimators (themselves held to fastbox_tpu's in
test_torch_spectra_estimators.py) at rtol 1e-10, atol 1e-8, in float64; the
sharded PCA filter equals ``filters.pca.pca_filter`` at 1e-9; the halo
counts are the same field on every mesh shape and equal the direct
``row_poisson`` draw, their mean is nbar V_voxel within 20%, and the
lognormal halo overdensity's cross power with the density is positive on
large scales.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastbox_tpu_torch.filters.pca import pca_filter
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra
from fastbox_tpu_torch.parallel import (local, make_mesh,
                                        make_sharded_halo_counts,
                                        make_sharded_power_multipoles,
                                        make_sharded_power_spectrum)
from fastbox_tpu_torch.parallel.rng import TAGS, row_poisson

N = 16
BOX = 800.0
RTOL, ATOL = 1e-10, 1e-8
WORLDS = (2, 4)

# (factory, kwargs) of the sharded spectra on the ranks
CALLS = [
    ("power", dict()),
    ("power", dict(nmu=4, los=(1.0, 2.0, 2.0), cross=True)),
    ("power", dict(nmu=3, exclude_zero=False, dk=0.03, kmin=0.01, kmax=0.2)),
    ("multipoles", dict(poles=(0, 1, 2, 3, 4), los=(0.0, 1.0, 1.0))),
    ("multipoles", dict(poles=(0, 1, 2), cross=True)),
    ("correlation", dict(dr=40.0, cross=True)),
    ("correlation", dict(dr=40.0, poles=(0, 2), los=(1.0, 1.0, 1.0))),
]
HALOS = dict(grid=(1e3, N), seed=9, nbar=1e-3, bias=1.6, seed_ln=4,
             nbar_ln=5e-3)


def cubes(n=N, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((n, n, n))) for _ in (0, 1)]


def single(grid, name, kw, a, b):
    """The single-device estimator a sharded factory stands for."""
    kw = dict(kw)
    second = b if kw.pop("cross", False) else None
    if name == "power":
        return spectra.power_spectrum(grid, a, second, **kw)
    if name == "multipoles":
        return spectra.power_multipoles(grid, a, second, **kw)
    if kw.get("poles") is None:
        kw.pop("poles", None)
        return spectra.correlation_function(grid, a, second, **kw)
    return spectra.correlation_multipoles(grid, a, second, **kw)


def assert_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, equal_nan=True,
                                   err_msg=k)
    np.testing.assert_array_equal(got["modes"].numpy(),
                                  want["modes"].numpy())


def pca_cube(nf=12, seed=5):
    """Smooth two-mode foregrounds plus white signal
    (tests/test_parallel_filters.py)."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(0.8, 1.2, nf)
    fg = (rng.standard_normal((N, N, 1)) * freqs[None, None, :] ** -2.7
          + 0.1 * rng.standard_normal((N, N, 1)) * freqs[None, None, :] ** 2.5)
    return torch.as_tensor(100.0 * fg + 0.01 * rng.standard_normal((N, N, nf)))


def halo_delta():
    return torch.as_tensor(0.5 * np.random.default_rng(3)
                           .standard_normal((N, N, N)))


@pytest.fixture(scope="module")
def ranks():
    """Each world's ranks' results of the spectra, filters and halos
    tasks."""
    a, b = cubes()
    payload = dict(
        tasks=["spectra", "filters", "halos"],
        spectra=dict(grid=(BOX, N), cube=a, second=b, calls=CALLS),
        filters=dict(grid=(1e3, N), data=pca_cube(), nmodes=2),
        halos=dict(HALOS, delta=halo_delta()))
    return {w: local.launch("fastbox_tpu_torch.parallel.local:tasks", w,
                            payload) for w in WORLDS}


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank ('ens' 1, 'space' 1) mesh in this process, on gloo."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("call", range(len(CALLS)))
def test_sharded_spectra_equal_single_device(ranks, world, call):
    grid = GridSpec.create(box_scale=BOX, nsamp=N)
    name, kw = CALLS[call]
    want = single(grid, name, kw, *cubes())
    for r in ranks[world]:   # every rank returns the whole result
        assert_close(r["spectra"][call], want)


def test_sharded_spectra_one_rank_odd_n(mesh1):
    """Odd N: no Nyquist planes, every kz > 0 plane interior."""
    grid = GridSpec.create(box_scale=750.0, nsamp=15)
    a, b = cubes(15, seed=23)
    kw = dict(nmu=3, los=(1.0, 0.0, 1.0), cross=True)
    assert_close(make_sharded_power_spectrum(mesh1, grid, device="cpu",
                                             **kw)(a, b),
                 single(grid, "power", kw, a, b))
    kw = dict(poles=(0, 1, 2))
    assert_close(make_sharded_power_multipoles(mesh1, grid, device="cpu",
                                               **kw)(a),
                 single(grid, "multipoles", kw, a, b))


def test_sharded_spectra_float32_and_arguments(mesh1, monkeypatch):
    grid = GridSpec.create(box_scale=BOX, nsamp=N)
    a, _ = cubes()
    a32 = a.float()
    got = make_sharded_power_spectrum(mesh1, grid, dtype=torch.float32,
                                      device="cpu")(a32)
    want = spectra.power_spectrum(grid, a32)
    assert got["power"].dtype == torch.float32
    np.testing.assert_array_equal(got["modes"].numpy(),
                                  want["modes"].numpy())
    np.testing.assert_allclose(got["power"].numpy(), want["power"].numpy(),
                               rtol=1e-5)
    fn = make_sharded_power_spectrum(mesh1, grid, device="cpu")
    with pytest.raises(ValueError, match="1 field"):
        fn(a, a)
    with pytest.raises(ValueError, match="slab"):
        fn(a[:, :8])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_sharded_power_spectrum(mesh1, grid)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pca_filter_equals_single_device(ranks, world):
    data = pca_cube()
    cleaned, _, _ = pca_filter(data, 2, return_filter=True)
    got = [torch.cat(part) for part in zip(*(r["filters"]
                                              for r in ranks[world]))]
    np.testing.assert_allclose(got[0].numpy(), cleaned.numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), (data - cleaned).numpy(),
                               rtol=1e-9, atol=1e-9)


def test_halo_counts_mesh_invariant_and_equal_to_direct_draw(ranks, mesh1):
    grid = GridSpec.create(box_scale=1e3, nsamp=N)
    counts = {w: torch.cat([r["halos"]["counts"] for r in ranks[w]])
              for w in WORLDS}
    nbar, bias = HALOS["nbar"], HALOS["bias"]
    counts[1] = make_sharded_halo_counts(mesh1, grid, nbar, bias)(
        HALOS["seed"], halo_delta())
    rate = torch.clamp(grid.voxel_volume * nbar
                       * (1.0 + bias * halo_delta().float()), min=0.0)
    direct = row_poisson(HALOS["seed"], TAGS["halos"], 0, rate)
    assert direct.dtype == torch.float32
    for w, c in counts.items():
        assert torch.equal(c, direct), w
    assert abs(direct.mean().item() / (nbar * grid.voxel_volume) - 1) < 0.2
    assert not torch.equal(direct, row_poisson(HALOS["seed"] + 1,
                                               TAGS["halos"], 0, rate))


def test_lognormal_halos_and_cross_spectrum(ranks):
    delta_h = {w: torch.cat([r["halos"]["delta_h"] for r in ranks[w]])
               for w in WORLDS}
    assert torch.equal(delta_h[2], delta_h[4])
    assert abs(delta_h[4].mean().item()) < 1e-10
    for w in WORLDS:
        out = ranks[w][0]["halos"]["cross"]
        pop = out["power"][out["modes"] > 0]
        assert torch.isfinite(pop).all()
        assert pop[:2].min().item() > 0.0


def test_halo_overdensity_of_an_empty_draw_is_zero(mesh1):
    grid = GridSpec.create(box_scale=1e3, nsamp=N)
    fn = make_sharded_halo_counts(mesh1, grid, nbar=0.0, bias=1.0,
                                  return_overdensity=True)
    out = fn(1, halo_delta())
    assert out.dtype == torch.float32 and not out.any()
