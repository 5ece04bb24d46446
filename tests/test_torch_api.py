"""The port's public functions take the JAX package's parameters, in its
order, so that a call written for one package does the same in the other.

For every public function of every module of ``cpu_tsdf_tpu`` that has a
counterpart of the same name in ``cpu_tsdf_tpu_torch``, the JAX
parameters (after the deliberate renames below) are a prefix of the
port's, and every parameter the port adds after them is keyword-only.
A further case holds the positional calls of the JAX package's own tests
on a small dense volume: a positional ``max_cubes`` once went to the
port's color switch, and a positional cube budget to its kernel switch.
"""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import tsdf_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

from test_fusion import tilted_pose
import torch_common  # noqa: F401  (one intra-op thread)

# Deliberate renames (ROADMAP, deliberate differences): the JAX name -> the
# port's. Parameters named pallas_* (tuning of the Pallas kernels) are
# dropped; a rename that repeats the parameter before it is merged into it.
RENAMES = {"use_pallas": "use_kernel", "split_key": "split_generator",
           "devices": "device", "platform": "device"}
# JAX modules with no counterpart: the Pallas kernels' own modules.
NO_COUNTERPART = {"cpu_tsdf_tpu.ops.pallas_fusion", "cpu_tsdf_tpu.ops.pallas_raycast"}


def _expected(names):
    out = []
    for n in names:
        if n.startswith("pallas_"):
            continue
        n = RENAMES.get(n, n)
        if not out or out[-1] != n:
            out.append(n)
    return out


def _public_functions(module):
    """(name, function) of the functions a module defines (jitted ones
    too), not those it imports."""
    for name, f in vars(module).items():
        if name.startswith("_") or inspect.isclass(f) or not callable(f):
            continue
        if module.__name__ in (getattr(f, "__module__", None),
                               getattr(getattr(f, "__wrapped__", None), "__module__", None)):
            yield name, f


def _pairs():
    for info in pkgutil.walk_packages(J.__path__, "cpu_tsdf_tpu."):
        if info.name in NO_COUNTERPART:
            continue
        jmod = importlib.import_module(info.name)
        tmod = importlib.import_module(info.name.replace("cpu_tsdf_tpu", "cpu_tsdf_tpu_torch", 1))
        for name, f in _public_functions(jmod):
            if hasattr(tmod, name):
                yield f"{info.name}.{name}", f, getattr(tmod, name)


def test_jax_parameters_are_a_prefix_of_the_port():
    pairs = list(_pairs())
    assert len(pairs) > 80
    bad = []
    for what, jf, tf in pairs:
        want = _expected(inspect.signature(jf).parameters)
        params = list(inspect.signature(tf).parameters.values())
        got = [p.name for p in params[:len(want)]]
        extra = [p.name for p in params[len(want):]
                 if p.kind not in (p.KEYWORD_ONLY, p.VAR_KEYWORD)]
        if got != want or extra:
            bad.append(f"{what}: JAX {want}, port {[p.name for p in params]}")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def dense():
    """A one-frame 32^3 dense volume of a sphere, JAX's and its port copy."""
    jcfg = J.TSDFConfig(
        xres=32, yres=32, zres=32, xsize=1.6, ysize=1.6, zsize=1.6,
        max_dist_pos=0.12, max_dist_neg=0.12, min_sensor_dist=0.1,
        max_sensor_dist=3.0, image_width=40, image_height=30,
        focal_length_x=35.0, focal_length_y=35.0, principal_point_x=20.0,
        principal_point_y=15.0, max_cell_size_x=0.4, max_cell_size_y=0.4,
        max_cell_size_z=0.4)
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    jv = J.integrate(J.make_volume(jcfg), jnp.asarray(depth),
                     jnp.asarray(tilted_pose(), jnp.float32))
    arrays = {k: None if getattr(jv, k) is None else np.asarray(getattr(jv, k))
              for k in ("sdf", "weight", "M", "nsample", "color", "global_transform")}
    return jv, tsdf_volume_from_arrays(TSDFConfig.from_json(jcfg.to_json()), arrays,
                                       device="cpu")


def test_positional_budgets_behave_as_jax(dense):
    """marching_cubes(vol, 0.5, 16) overflows its budget of 16 cubes in both
    packages, with no colors (tests/test_marching_cubes.py's call); with a
    budget of 4096 it gives JAX's triangles. extract_mesh(vol, 0.5, False,
    False, 4096) sizes the dense budget to 4096 in both and gives JAX's
    mesh; a budget below the crossing cubes raises in both."""
    jv, tv = dense
    n_active = tmc.count_active_cubes(tv, 0.5)
    assert 16 < n_active < 4096 and n_active == jmc.count_active_cubes(jv, 0.5)
    for budget in (16, 4096):
        js, ts = jmc.marching_cubes(jv, 0.5, budget), tmc.marching_cubes(tv, 0.5, budget)
        assert bool(ts.overflowed) == bool(js.overflowed) == (budget == 16)
        assert ts.colors is None and js.colors is None
        assert ts.vertices.shape == js.vertices.shape == (budget * 5, 3, 3)
        np.testing.assert_array_equal(ts.tri_valid.numpy(), np.asarray(js.tri_valid))
    jverts, jfaces, _ = jmc.extract_mesh(jv, 0.5, False, False, 4096)
    tverts, tfaces, tcols = tmc.extract_mesh(tv, 0.5, False, False, 4096)
    assert tcols is None and len(tfaces) == len(jfaces) > 100
    np.testing.assert_allclose(tverts, jverts, atol=1e-5)
    for extract in (jmc.extract_mesh, tmc.extract_mesh):
        vol = jv if extract is jmc.extract_mesh else tv
        with pytest.raises(RuntimeError, match="overflowed"):
            extract(vol, 0.5, False, False, 16)
