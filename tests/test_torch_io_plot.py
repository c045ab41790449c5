"""The port's ``io`` and ``plot`` against fastbox_tpu's, on the CPU.

The npz helpers round-trip tensors exactly; a box saved by either
package's ``save_box`` loads into the other's ``load_box`` with its grid,
cosmology, dtype and fields unchanged, bit for bit.  ``save_sharded`` /
``load_sharded`` (``torch.distributed.checkpoint``) write a cube's rows
from 4 gloo ranks and restore them, bitwise, onto 4 and 2 ranks as slabs
and onto every rank whole; a plain tensor with no mesh is refused on more
than one rank (the checkpointer would write rank 0's rows alone) and saved
whole by a single process.  ``animate_field`` draws the frames fastbox_tpu's
draws (Agg).
"""
import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from fastbox_tpu import io as jio  # noqa: E402
from fastbox_tpu import plot as jplot  # noqa: E402
from fastbox_tpu.box import CosmoBox as JaxBox  # noqa: E402
from fastbox_tpu_torch import io as tio  # noqa: E402
from fastbox_tpu_torch import plot as tplot  # noqa: E402
from fastbox_tpu_torch.box import CosmoBox, default_cosmo  # noqa: E402
from fastbox_tpu_torch.parallel import local  # noqa: E402

KW = dict(cosmo=default_cosmo, box_scale=(1e3, 1e3, 8e2), nsamp=8,
          redshift=0.8, realise_now=False, seed=4)


def test_save_load_fields(tmp_path):
    path = str(tmp_path / "fields.npz")
    a = torch.arange(8.0).reshape(2, 4)
    c = torch.complex(torch.arange(4.0), -torch.arange(4.0))
    tio.save_fields(path, a=a, c=c, n=np.ones(3), skipped=None)
    got = tio.load_fields(path, device="cpu")
    assert set(got) == {"a", "c", "n"}
    assert torch.equal(got["a"], a) and torch.equal(got["c"], c)
    # fastbox_tpu reads the port's file, and the port reads fastbox_tpu's
    np.testing.assert_array_equal(np.asarray(jio.load_fields(path)["c"]),
                                  c.numpy())
    jio.save_fields(str(tmp_path / "j.npz"), c=jnp.asarray(c.numpy()))
    assert torch.equal(tio.load_fields(str(tmp_path / "j.npz"),
                                       device="cpu")["c"], c)


def test_load_fields_needs_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means the card")
    path = str(tmp_path / "f.npz")
    tio.save_fields(path, a=torch.zeros(2))
    with pytest.raises(ValueError, match="no CUDA device"):
        tio.load_fields(path)


def realised(box):
    box.realise_density()
    box.realise_velocity()
    box.realise_potential()
    return box


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_box_round_trips_across_packages(tmp_path, dtype):
    names = ("delta_x", "delta_k", "phi_k")
    jb = realised(JaxBox(dtype=getattr(jnp, dtype), **KW))
    jio.save_box(str(tmp_path / "j.npz"), jb)
    tb = tio.load_box(str(tmp_path / "j.npz"), device="cpu")
    assert tb.dtype == getattr(torch, dtype)
    assert tb.device == torch.device("cpu")
    assert tb.grid.N == 8 and (tb.Lx, tb.Ly, tb.Lz) == (1e3, 1e3, 8e2)
    assert tb.redshift == jb.redshift and tb.cosmo.h == jb.cosmo.h
    for name in names:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    for a, b in zip(tb.velocity_k, jb.velocity_k):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    pb = realised(CosmoBox(dtype=getattr(torch, dtype), device="cpu", **KW))
    tio.save_box(str(tmp_path / "t.npz"), pb)
    back = jio.load_box(str(tmp_path / "t.npz"))
    assert back.dtype == jnp.dtype(dtype)
    assert back.grid.Lz == 8e2 and back.cosmo.sigma8 == pb.cosmo.sigma8
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(pb, name).numpy())
    again = tio.load_box(str(tmp_path / "t.npz"), device="cpu")
    for name in names:
        assert torch.equal(getattr(again, name), getattr(pb, name))
    for a, b in zip(again.velocity_k, pb.velocity_k):
        assert torch.equal(a, b)


def test_box_without_fields(tmp_path):
    tio.save_box(str(tmp_path / "e.npz"), CosmoBox(device="cpu", **KW))
    box = tio.load_box(str(tmp_path / "e.npz"), device="cpu")
    assert box.delta_x is None and box.velocity_k is None
    assert box.dtype == torch.get_default_dtype()


def test_save_sharded_in_one_process(tmp_path):
    """No process group: plain tensors are saved and restored whole."""
    tree = {"delta": torch.randn(6, 4, 4), "meta": {"steps": torch.tensor(3)}}
    tio.save_sharded(str(tmp_path / "ck"), tree)
    got = tio.load_sharded(str(tmp_path / "ck"), {
        "delta": torch.zeros(6, 4, 4), "meta": {"steps": torch.tensor(0)}})
    assert torch.equal(got["delta"], tree["delta"])
    assert got["meta"]["steps"].item() == 3


def test_save_sharded_over_gloo_ranks(tmp_path):
    """4 ranks write their rows (the rows of a plain tensor with no mesh
    are refused); 4 and 2 ranks read them back as slabs, and whole."""
    cube = torch.randn((8, 6, 5), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(9))
    spec = dict(cube=cube, path=str(tmp_path / "ck"), steps=16)
    target = "fastbox_tpu_torch.parallel.local:tasks"
    four = local.launch(target, 4, dict(tasks=["io"], io=dict(
        spec, modes=["unsharded", "save", "load"])))
    two = local.launch(target, 2, dict(tasks=["io"], io=dict(
        spec, modes=["load"])))
    for res in (four, two):
        got = [r["io"]["load"] for r in res]
        assert torch.equal(torch.cat([g["rows"] for g in got]), cube)
        assert all(torch.equal(g["whole"], cube) for g in got)
        assert [g["steps"] for g in got] == [16] * len(res)
    for r in four:
        assert "needs the mesh" in r["io"]["unsharded"]


def test_animate_field(rng):
    field = rng.standard_normal((4, 8, 6))
    frames = {}
    for name, mod, arg in (("jax", jplot, field),
                           ("torch", tplot, torch.as_tensor(field))):
        anim = mod.animate_field(arg, axis=0)
        anim._init_draw()
        for i in range(2):
            anim._draw_frame(i)
        im = anim._fig.axes[0].images[0]
        frames[name] = (np.asarray(im.get_array()), im.get_clim())
    np.testing.assert_array_equal(frames["torch"][0], frames["jax"][0])
    assert frames["torch"][1] == frames["jax"][1]
    anim = tplot.animate_field(torch.as_tensor(field), axis=2, vmin=-1.0,
                               vmax=1.0)
    assert anim._fig.axes[0].images[0].get_clim() == (-1.0, 1.0)
    import matplotlib.pyplot as plt

    plt.close("all")
