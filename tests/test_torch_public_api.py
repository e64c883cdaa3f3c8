"""The port's public surface against the JAX package's: every top-level
public function and class of every JAX module, every public method of its
public classes and every name its `__init__` files export must be in the
same module of the port, or in EXCLUDED with its reason.  The JAX files
are read with `ast` (nothing of them is imported).  The one-substep entry
points, the struct-form transfers and particle update, and the SVD, pose,
body and grid helpers take the JAX parameter names in the JAX order (with
`comm` where JAX takes `axis_name`); the port may add trailing parameters
with defaults (`device`, `dtype`)."""

import ast
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "wgsparkl_tpu"

# JAX modules whose names live in other modules of the port.
RENAMED = {
    "ops.pallas_cdf": ("ops.p2g_cdf",),
    "ops.pallas_transfer": ("ops.rows", "ops.p2g", "ops.g2p"),
    "ops.pallas_transfer2d": ("ops.rows2d", "ops.transfer2d"),
}

# TPU workarounds the port does not carry: (module, name) -> (why, the
# port's counterpart).
_TILE_MOVES = ("one-hot matrix-product tile moves for the MXU",
               "ops/blocked.gather_tiles / scatter_tiles (an indexed gather, "
               "an ordered row add)")
_BANDS = ("band dispatch of the one-hot tile moves", "none needed")
_SEL3 = ("Dekker 3-pass exact selection through bf16 MXU passes", "none needed")
EXCLUDED = {
    ("collision.shapes", "jax_onehot"): ("one-hot selection for the MXU",
                                         "plain indexing"),
    ("ops.blocked", "sel3_dot"): _SEL3,
    ("ops.blocked", "sel3_dot_kernel"): _SEL3,
    ("ops.blocked", "sel3_dot_mstack"): _SEL3,
    ("ops.blocked", "band_info"): _BANDS,
    ("ops.blocked", "band_info_chunks"): _BANDS,
    ("ops.blocked", "band_info_slots"): _BANDS,
    ("ops.blocked", "band_info_slots_chunks"): _BANDS,
    ("ops.blocked", "gather_tiles_mm"): _TILE_MOVES,
    ("ops.blocked", "scatter_tiles_mm"): _TILE_MOVES,
    ("ops.blocked", "gather_tiles_banded"): _TILE_MOVES,
    ("ops.blocked", "scatter_tiles_banded"): _TILE_MOVES,
    ("ops.blocked", "gather_tiles_auto"): _TILE_MOVES,
    ("ops.blocked", "scatter_tiles_auto"): _TILE_MOVES,
    ("ops.blocked", "gather_tiles_slots"): (
        "banded or one-hot slot moves", "ops/blocked.window_sources_slots, held "
        "against them (tests/test_torch_sparse_tables.py)"),
    ("ops.blocked", "scatter_tiles_slots"): (
        "banded or one-hot slot moves", "ops/blocked.window_sources_slots"),
    ("ops.pallas_transfer", "phys_dot"): ("bf16 split dot for the MXU", "none needed"),
    ("parallel.domain", "state_specs"): (
        "a jax.sharding.PartitionSpec pytree", "parallel/domain.shard_state splits "
        "the same leaves"),
    ("parallel", "state_specs"): ("a jax.sharding.PartitionSpec pytree",
                                  "parallel/domain.shard_state"),
}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(JAX_PKG).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _public_names(path: pathlib.Path):
    """Top-level public functions and classes, ClassName.method for their
    public methods, and (in an __init__) every imported public name."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")]
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names += [a.asname or a.name for a in node.names
                      if not (a.asname or a.name).startswith("_")]
    return names


MODULES = sorted(_module_name(p) for p in JAX_PKG.rglob("*.py"))


def _port_modules(mod: str):
    return [importlib.import_module("wgsparkl_tpu_torch" + (f".{m}" if m else ""))
            for m in RENAMED.get(mod, (mod,))]


def _lookup(mods, name: str):
    for m in mods:
        obj = m
        try:
            for part in name.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            continue
        return obj
    return None


def _missing(mod: str):
    path = JAX_PKG.joinpath(*mod.split(".")) if mod else JAX_PKG
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    mods = _port_modules(mod)
    return [n for n in _public_names(path) if _lookup(mods, n) is None]


def test_modules_found():
    assert len(MODULES) > 40 and "pipeline" in MODULES and "" in MODULES


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "wgsparkl_tpu")
def test_public_names_ported(mod):
    """Every public name of the JAX module is in the port, or excluded."""
    missing = [n for n in _missing(mod) if (mod, n) not in EXCLUDED]
    assert not missing, f"{mod or 'wgsparkl_tpu'}: not in the port: {missing}"


def test_exclusions_are_missing_and_explained():
    """The table names only what the port lacks, each with a reason and a
    counterpart; the JAX names it lists exist."""
    for (mod, name), (why, counterpart) in EXCLUDED.items():
        assert mod in MODULES, mod
        assert name in _missing(mod), f"{mod}.{name} is in the port: drop it from EXCLUDED"
        assert why and counterpart


# Entry points whose JAX parameter names the port keeps: (JAX module, name).
SIGNATURES = [
    ("pipeline", "substep"), ("pipeline", "substep_blocked"),
    ("pipeline", "substep_pallas"),
    ("ops.transfer", "p2g"), ("ops.transfer", "g2p"),
    ("ops.blocked_transfer", "p2g_blocked"), ("ops.blocked_transfer", "g2p_blocked"),
    ("ops.particle_update", "particle_update"),
    ("ops.particle_update", "particle_update_channels_2d"),
    ("collision.cdf", "node_cdf"),
    ("math.svd", "svd2x2"), ("math.svd", "svd3x3"), ("math.svd", "svd"),
    ("math.svd", "recompose"),
    ("math.pose", "quat_identity"), ("math.pose", "quat_from_axis_angle"),
    ("math.pose", "rot2_identity"), ("math.pose", "rot_identity"),
    ("math.pose", "inv_transform_point"),
    ("rigid.body", "make_rigid_world"), ("rigid.body", "velocity_at_point"),
    ("grid", "GridConfig.node_positions"),
    ("ops.kernel", "eval_all"), ("ops.rigid_cdf", "blocks_to_flat"),
    ("ops.blocked", "particle_block_ids"), ("ops.blocked", "particle_block_ids_ch"),
    ("ops.blocked", "sort_by_block"), ("ops.blocked", "window_weights"),
    ("ops.blocked", "window_node_positions"), ("ops.blocked", "window_node_offsets"),
]


def _jax_params(mod: str, name: str):
    tree = ast.parse((JAX_PKG.joinpath(*mod.split(".")).with_suffix(".py")).read_text())
    body = tree.body
    *cls, fn = name.split(".")
    for c in cls:
        body = next(n for n in body if isinstance(n, ast.ClassDef) and n.name == c).body
    node = next(n for n in body if isinstance(n, ast.FunctionDef) and n.name == fn)
    return [a.arg for a in node.args.posonlyargs + node.args.args + node.args.kwonlyargs]


@pytest.mark.parametrize("mod,name", SIGNATURES, ids=lambda x: str(x))
def test_entry_point_parameters(mod, name):
    jax_names = ["comm" if a == "axis_name" else a for a in _jax_params(mod, name)]
    fn = _lookup(_port_modules(mod), name)
    params = list(inspect.signature(fn).parameters.values())
    assert [p.name for p in params[:len(jax_names)]] == jax_names
    assert all(p.default is not inspect.Parameter.empty for p in params[len(jax_names):])


def test_package_exports():
    """The top-level, math, rigid and ops packages export what the JAX
    package's do, and importing them builds no kernel."""
    import wgsparkl_tpu_torch as wt
    from wgsparkl_tpu_torch import math, ops, rigid
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.rigid.body import BodyCoupling, RigidWorld

    assert wt.SimulationParams is SimulationParams
    assert wt.models.ElasticCoefficients and wt.solver.Particles
    assert rigid.RigidWorld is RigidWorld and rigid.BodyCoupling is BodyCoupling
    assert set(math.__all__) >= {"svd2x2", "svd3x3", "svd", "recompose", "pose"}
    assert set(ops.__all__) == {"eval_all", "inv_d", "stencil_base_and_weights",
                                "stencil_offsets"}
    assert all(w.launches == 0 for w in wt.kernel_wrappers().values())


def _new_constructors():
    from wgsparkl_tpu_torch.grid import GridConfig
    from wgsparkl_tpu_torch.math import pose
    from wgsparkl_tpu_torch.rigid.body import make_rigid_world

    return {
        "make_rigid_world": lambda: make_rigid_world(3, 2).rot,
        "quat_identity": lambda: pose.quat_identity((2,)),
        "rot2_identity": lambda: pose.rot2_identity((2,)),
        "rot_identity": lambda: pose.rot_identity(3, (2,)),
        "GridConfig.node_positions": lambda: GridConfig((4, 4), 0.5, (0, 0)).node_positions(),
    }


@pytest.mark.parametrize("call", ["make_rigid_world", "quat_identity", "rot2_identity",
                                  "rot_identity", "GridConfig.node_positions"])
def test_new_constructors_default_to_the_card(call):
    """Called with no device, the new constructors build on the card; without
    one they raise and never fall back to the CPU."""
    import torch

    fn = _new_constructors()[call]
    if torch.cuda.is_available():
        assert fn().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
