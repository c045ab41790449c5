"""Every public name of every fastbox_tpu module exists in the port.

For each module of ``fastbox_tpu`` (``ops.pallas.*``, the TPU kernels, have
their CUDA counterparts under other names), the port's module of the same
path must exist and hold every name of the module's ``__all__`` (or, where
it has none, every public name it defines).  The names ROADMAP A lists as
TPU-only workarounds, which the port leaves out on purpose, are listed
here.
"""
import importlib
import inspect
import pkgutil

import pytest

import fastbox_tpu

# ROADMAP A's do-not-port list: the C2C, 1D and 2D reroutes and the
# native-FFT probe of fft_safe, mmfft's dense ladder and pair tricks, and
# the Box-Muller rows that erf_inv's TPU lowering forced.
DO_NOT_PORT = {
    "ops.fft_safe": {"fft", "ifft", "rfft", "irfft", "fft2", "ifft2",
                     "rfft2", "irfft2", "native_fft_ok", "matmul_only"},
    "ops.mmfft": {"fft", "ifft", "fftn", "ifftn", "fft2", "ifft2", "rfft",
                  "irfft", "rfftn_via_cfft", "irfftn_pair"},
    "parallel.rng": {"bm_pair"},
}

MODULES = [""] + sorted(
    m.name[len("fastbox_tpu."):] for m in pkgutil.walk_packages(
        fastbox_tpu.__path__, "fastbox_tpu.")
    if not m.name.startswith("fastbox_tpu.ops.pallas"))


def public_names(mod) -> list:
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", mod.__name__) == mod.__name__]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p or "package")
def test_port_has_every_public_name(path):
    suffix = "." + path if path else ""
    ref = importlib.import_module("fastbox_tpu" + suffix)
    port = importlib.import_module("fastbox_tpu_torch" + suffix)
    skip = DO_NOT_PORT.get(path, set())
    names = public_names(ref)
    assert skip <= set(names), "a do-not-port name left fastbox_tpu"
    missing = [n for n in names if n not in skip and not hasattr(port, n)]
    assert not missing, f"fastbox_tpu_torch{suffix} lacks {missing}"


def test_module_walk_covers_the_packages():
    assert {"analysis.voids", "analysis.forecast", "timing",
            "parallel.cola", "filters.gpr", "ops.painting"} <= set(MODULES)


def test_cosmology_has_H_and_pk():
    from fastbox_tpu.cosmology.tables import Cosmology as Ref
    from fastbox_tpu_torch.cosmology.tables import Cosmology

    for name in ("H", "pk"):
        assert hasattr(Ref, name) and hasattr(Cosmology, name)
    assert isinstance(Cosmology.H, property)
    assert list(inspect.signature(Cosmology.pk).parameters) == [
        "self", "k", "linear"]
