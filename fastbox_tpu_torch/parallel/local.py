"""Run a function on local CPU ranks under gloo.

``launch("package.module:function", world_size, payload)`` starts
``world_size`` Python processes (``python -m fastbox_tpu_torch.parallel.
local``).  Each joins a gloo process group on a shared file store, calls
``function(payload)`` and saves what it returns; ``launch`` returns the
ranks' results in rank order, or raises with the failing rank's errors.
The payload and the results travel through ``torch.save`` files in a
temporary directory.

``tasks`` runs the checks the CPU tests make on 2 and 4 ranks, named in
``payload["tasks"]``: ``fft`` (each slab FFT helper on this rank's rows),
``sharded_step`` and ``ensemble`` (``make_ensemble_pipeline`` over a mesh
of the world's ranks), ``spectra``, ``filters`` and ``halos`` (the sharded
estimators, PCA filter and halo counts on this rank's rows, 'space' = the
world), ``lattice`` (the halo-exchange paint and gather on this rank's
rows), ``cola`` (``make_sharded_cola`` on supplied white noise, and its
ensemble mode against single calls) and ``io`` (``io.save_sharded`` of
this rank's rows, ``io.load_sharded`` into slab and whole templates).
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["launch", "tasks", "fft", "sharded_step", "ensemble", "spectra",
           "filters", "halos", "lattice", "cola", "io"]

_ROOT = Path(__file__).resolve().parents[2]


def launch(target: str, world_size: int, payload=None,
           timeout: float = 300.0) -> list:
    """``target`` ("module:function") on ``world_size`` gloo ranks; returns
    the list of the ranks' return values."""
    with tempfile.TemporaryDirectory(prefix="fastbox_ranks_") as tmp:
        tmp = Path(tmp)
        torch.save(payload, tmp / "payload.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", __name__, target, str(r), str(world_size),
             str(tmp)], cwd=_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world_size)]
        errors = []
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    errors.append(f"rank {r} exited {p.returncode}:\n{err}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if errors:
            raise RuntimeError("\n".join(errors))
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]


def _main(target: str, rank: int, world_size: int, tmp: str) -> None:
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        payload = torch.load(os.path.join(tmp, "payload.pt"),
                             weights_only=False)
        result = fn(payload)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _setup(spec: dict):
    """(grid, cosmology, amp_half, config) of a task's spec: the grid's
    (box, N, redshift), the cosmology as ``convert.from_jax_state``'s state
    dict and the ``PipelineConfig`` keywords."""
    from ..convert import from_jax_state
    from ..grid import GridSpec
    from ..pipeline import PipelineConfig

    box, n, z = spec["grid"]
    cosmo, amp = from_jax_state(spec["state"])
    return (GridSpec.create(box_scale=box, nsamp=n, redshift=z), cosmo, amp,
            PipelineConfig(**spec["config"]))


def tasks(payload: dict) -> dict:
    """{name: result} of every task named in ``payload["tasks"]``."""
    return {name: _TASKS[name](payload) for name in payload["tasks"]}


def fft(payload: dict) -> dict:
    """This rank's rows of each slab FFT helper applied to the full batched
    cubes ``payload["fft"]["complex"]`` and ``["real"]`` (B, N, N, N), on a
    mesh whose 'space' axis holds every rank."""
    from . import fft as pf
    from .mesh import axis_group, make_mesh

    mesh = make_mesh(dist.get_world_size(), space=dist.get_world_size(),
                     device="cpu")
    group, P, r = axis_group(mesh, "space")
    xc, xr = payload["fft"]["complex"], payload["fft"]["real"]
    n = xr.shape[1]
    rows = slice(r * n // P, (r + 1) * n // P)
    xc, xr = xc[:, rows].contiguous(), xr[:, rows].contiguous()
    return {"pfft3": pf.pfft3_local(xc, group),
            "pifft3": pf.pifft3_local(xc, group),
            "pfft2": pf.pfft2_local(xc, group),
            "pifft2": pf.pifft2_local(xc, group),
            "prfft3": pf.prfft3_local(xr, group),
            "pirfft3": pf.pirfft3_local(pf.prfft3_local(xr, group), n, group)}


def sharded_step(payload: dict) -> list:
    """The outputs of the sharded step for each spec of ``payload["steps"]``,
    on a mesh of every rank with 'space' = ``spec["space"]``, on the B
    realisations' ``spec["draws"]``, or drawn from ``spec["seeds"]``."""
    from .mesh import make_mesh
    from .sharded import make_sharded_ensemble_step

    outs = []
    for spec in payload["steps"]:
        grid, cosmo, amp, config = _setup(spec)
        mesh = make_mesh(dist.get_world_size(), space=spec["space"],
                         device="cpu")
        step = make_sharded_ensemble_step(mesh, grid, cosmo, config, "cpu",
                                          amp)
        outs.append(step(seeds=spec["seeds"]) if "seeds" in spec
                    else step(draws=spec["draws"]))
    return outs


def ensemble(payload: dict) -> dict:
    """``make_ensemble_pipeline(mesh=...)`` over every rank ('space' = 1) on
    generators seeded with ``payload["ensemble"]["seeds"]``."""
    from ..pipeline import make_ensemble_pipeline
    from .mesh import make_mesh

    spec = payload["ensemble"]
    grid, cosmo, amp, config = _setup(spec)
    mesh = make_mesh(dist.get_world_size(), space=1, device="cpu")
    fn = make_ensemble_pipeline(grid, cosmo, config, "cpu", mesh, amp)
    return fn([torch.Generator().manual_seed(s) for s in spec["seeds"]])


def _space_slabs(spec: dict):
    """(mesh, grid, this rank's row slice) of a task spec's (box, N), the
    mesh's 'space' axis holding every rank."""
    from ..grid import GridSpec
    from .mesh import axis_group, make_mesh

    box, n = spec["grid"]
    P = dist.get_world_size()
    mesh = make_mesh(P, space=P, device="cpu")
    r = axis_group(mesh, "space")[2]
    return mesh, GridSpec.create(box_scale=box, nsamp=n), \
        slice(r * n // P, (r + 1) * n // P)


def spectra(payload: dict) -> list:
    """Each ``(factory, kwargs)`` of ``payload["spectra"]["calls"]`` ('power',
    'multipoles' or 'correlation') built on the spec's grid and applied to
    this rank's rows of ``cube`` (and of ``second`` when ``cross``)."""
    from . import spectra as ps

    spec = payload["spectra"]
    mesh, grid, rows = _space_slabs(spec)
    make = {"power": ps.make_sharded_power_spectrum,
            "multipoles": ps.make_sharded_power_multipoles,
            "correlation": ps.make_sharded_correlation}
    outs = []
    for name, kw in spec["calls"]:
        fields = [spec["cube"][rows]]
        if kw.get("cross"):
            fields.append(spec["second"][rows])
        outs.append(make[name](mesh, grid, device="cpu", **kw)(*fields))
    return outs


def filters(payload: dict) -> tuple:
    """This rank's rows of ``make_sharded_pca_filter``'s (cleaned, fit) of
    ``payload["filters"]["data"]`` (N, N, Nfreq)."""
    from .filters import make_sharded_pca_filter

    spec = payload["filters"]
    mesh, grid, rows = _space_slabs(spec)
    return make_sharded_pca_filter(mesh, grid, spec["nmodes"])(
        spec["data"][rows])


def halos(payload: dict) -> dict:
    """This rank's rows of the halo counts of ``payload["halos"]["delta"]``
    (linear rate), and of the lognormal halo overdensity with its sharded
    cross power spectrum against the density."""
    from .halos import make_sharded_halo_counts
    from .spectra import make_sharded_power_spectrum

    spec = payload["halos"]
    mesh, grid, rows = _space_slabs(spec)
    delta = spec["delta"][rows]
    counts = make_sharded_halo_counts(mesh, grid, spec["nbar"], spec["bias"])(
        spec["seed"], delta)
    delta_h = make_sharded_halo_counts(
        mesh, grid, spec["nbar_ln"], 1.0, lognormal=True,
        return_overdensity=True, dtype=torch.float64)(spec["seed_ln"], delta)
    cross = make_sharded_power_spectrum(mesh, grid, cross=True,
                                        device="cpu")(delta_h, delta)
    return {"counts": counts, "delta_h": delta_h, "cross": cross}


def lattice(payload: dict) -> dict:
    """{B: outputs} of the halo primitives on this rank's rows of
    ``payload["lattice"]``'s full cubes, 'space' = the world: for each B of
    ``disp`` ({B: (N, N, N, 3)}), ``paint``, ``paint_w`` (``weights``
    (N, N, N)), ``paint_many`` and ``gather_many`` of ``meshes``
    (3, N, N, N), and ``paint_single``/``gather_single``, the per-channel
    calls."""
    from . import lattice as hl
    from .mesh import axis_group, make_mesh

    spec = payload["lattice"]
    P = dist.get_world_size()
    group, _, r = axis_group(make_mesh(P, space=P, device="cpu"), "space")
    n = spec["weights"].shape[0]
    rows = slice(r * n // P, (r + 1) * n // P)
    w, m = spec["weights"][rows], spec["meshes"][:, rows]
    out = {}
    for B, disp in spec["disp"].items():
        d = disp[rows]
        out[B] = {"paint": hl.halo_paint(d, B, group),
                  "paint_w": hl.halo_paint(d, B, group, weights=w),
                  "paint_many": hl.halo_paint_many(d, B, group, m),
                  "gather_many": hl.halo_gather_many(m, d, B, group),
                  "paint_single": [hl.halo_paint(d, B, group, weights=c)
                                   for c in m],
                  "gather_single": [hl.halo_gather(c, d, B, group)
                                    for c in m]}
    return out


def cola(payload: dict) -> list:
    """``make_sharded_cola`` for each spec of ``payload["cola"]`` on a mesh
    of every rank with 'space' = ``spec["space"]``, in the spec's dtype on
    its grid (box, N, z) and cosmology parameters: ``fn(white=...)`` on the
    full white field ``spec["white"]``, ``fn(seed=...)`` with
    ``spec["seed"]``, or, with ``spec["seeds"]``, the
    ensemble call ``fn(seeds=...)`` beside single calls on each seed
    (``{"ensemble": ..., "single": [...]}``)."""
    from ..cosmology import build_cosmology
    from ..grid import GridSpec
    from .cola import make_sharded_cola
    from .mesh import make_mesh

    outs = []
    for spec in payload["cola"]:
        box, n, z = spec["grid"]
        grid = GridSpec.create(box_scale=box, nsamp=n, redshift=z)
        cosmo = build_cosmology(spec["cosmo"], redshift=z)
        mesh = make_mesh(dist.get_world_size(), space=spec["space"],
                         device="cpu")
        kw = dict(spec["kw"], device="cpu")
        if "seed" in spec:
            outs.append(make_sharded_cola(mesh, grid, cosmo, **kw)(
                seed=spec["seed"]))
            continue
        if "seeds" not in spec:
            outs.append(make_sharded_cola(mesh, grid, cosmo, **kw)(
                white=spec["white"]))
            continue
        one = make_sharded_cola(mesh, grid, cosmo, **kw)
        outs.append({
            "ensemble": make_sharded_cola(mesh, grid, cosmo, ensemble=True,
                                          **kw)(seeds=spec["seeds"]),
            "single": [one(seed=sd) for sd in spec["seeds"]]})
    return outs


def io(payload: dict) -> dict:
    """Each mode of ``payload["io"]["modes"]``, in order, on a mesh of every
    rank ('space' = the world): 'save' writes this rank's rows of ``cube``
    (N, ...) as a plain tensor over the mesh and ``steps`` as a replicated
    ``DTensor`` to ``path``; 'load' restores ``path`` into ``DTensor`` slab
    templates (this rank's rows) and into a plain tensor (the whole cube on
    every rank); 'unsharded' saves this rank's rows with no mesh to
    ``path`` + '_unsharded', which must be refused on more than one rank
    (the error's message, or None)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from .. import io as fio
    from .mesh import make_mesh

    spec = payload["io"]
    P, r = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(P, space=P, device="cpu")
    cube, path = spec["cube"], spec["path"]
    n = cube.shape[0]
    rows = cube[r * n // P:(r + 1) * n // P].clone()
    replicated = [Replicate(), Replicate()]
    out = {}
    for mode in spec["modes"]:
        if mode == "save":
            steps = DTensor.from_local(torch.tensor(spec["steps"]), mesh,
                                       replicated)
            fio.save_sharded(path, {"delta": rows, "meta": {"steps": steps}},
                             mesh)
        elif mode == "unsharded":
            try:
                fio.save_sharded(path + "_unsharded", {"delta": rows})
                out[mode] = None
            except ValueError as exc:
                out[mode] = str(exc)
        else:
            slab = fio.load_sharded(path, {
                "delta": DTensor.from_local(torch.full_like(rows, torch.nan),
                                            mesh, [Replicate(), Shard(0)]),
                "meta": {"steps": DTensor.from_local(torch.tensor(-1), mesh,
                                                     replicated)}})
            whole = fio.load_sharded(path, {
                "delta": torch.full_like(cube, torch.nan)})
            out[mode] = {"rows": slab["delta"].to_local(),
                         "steps": slab["meta"]["steps"].to_local().item(),
                         "whole": whole["delta"]}
    return out


_TASKS = {"fft": fft, "sharded_step": sharded_step, "ensemble": ensemble,
          "spectra": spectra, "filters": filters, "halos": halos,
          "lattice": lattice, "cola": cola, "io": io}

if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
