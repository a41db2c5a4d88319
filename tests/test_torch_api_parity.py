"""The port's public API against the JAX package's, by their source alone.

Both packages are parsed with `ast`; neither is imported, so this runs in
well under a second.  Every public (not underscore-prefixed) top-level
function and class of `lap_time_optimization_tpu/`, and every public method
of such a class, must exist under the same module path and name in
`lap_time_optimization_tpu_torch/`, and take every parameter name the JAX
one takes (the port may take more: `device`, `solver`, a generator).  The
only exceptions are the allow-lists below, each with its reason.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "lap_time_optimization_tpu")
PORT_PKG = os.path.join(REPO, "lap_time_optimization_tpu_torch")

# JAX names the port replaces by another module's function ("module:name" in
# the port), or leaves out (None).
REPLACED = {
    # The Pallas wrappers: the CUDA whole-solve kernel (kernels 1-2, no
    # per-iteration call and no tables to pack by hand) and kernel 3.
    "ops/pallas_ilqr.py:backward_forward": "ops/ilqr.py:solve",
    "ops/pallas_ilqr.py:scal_vector": "ops/ilqr.py:solve",
    "ops/pallas_ilqr.py:tables_matrix": "ops/ilqr.py:solve",
    "ops/pallas_ilqr_batch.py:backward_forward_batch": "ops/ilqr.py:solve",
    "ops/pallas_ilqr_batch.py:window_tables": "ops/ilqr.py:solve",
    "ops/pallas_velocity.py:solve_profile_batch": "ops/velocity_batch.py:solve_profile_batch",
    # The CUDA kernel reads the whole track table, from shared memory or,
    # past what a block holds, from global memory, at any length: there is
    # no table window to size or check.
    "mpc/solver.py:ensure_batch_window": None,
    "mpc/solver.py:required_batch_window": None,
    # JAX's --platform/--x64 flags become --device/--dtype.
    "cli/race.py:apply_backend_flags": None,
}

# Parameters of a JAX function that the port's counterpart does not take.
DROPPED = {
    # JAX's own fit deletes them unused (lap_time_optimization_tpu/ops/gp.py:105).
    "ops/gp.py:fit": {"key", "n_restarts", "max_iter"},
    # The JAX coordinator's arguments: torchrun's environment (or
    # init_method, world_size and rank) replaces them.
    "parallel/distributed.py:initialize": {"coordinator_address", "num_processes", "process_id"},
    # jax.random keys become a torch.Generator (`gen`).
    "parallel/mesh.py:search_step": {"key"},
    "parallel/mesh.py:search_step_dp_sp": {"key"},
    # The sequence axis is the DeviceMesh's "sp" dimension, not a name.
    "parallel/sp_velocity.py:solve_profile_sp": {"axis"},
}


def _params(fn) -> set:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    names |= {f"*{v.arg}" for v in (a.vararg, a.kwarg) if v is not None}
    return names


def public_api(path: str) -> dict:
    """{name or Class.method: parameter names (None for a class)} of the
    module at `path`."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    api = {}
    for node in tree.body:
        if not isinstance(node, (*funcs, ast.ClassDef)) or node.name.startswith("_"):
            continue
        if isinstance(node, funcs):
            api[node.name] = _params(node)
        else:
            api[node.name] = None
            for sub in node.body:
                if isinstance(sub, funcs) and not sub.name.startswith("_"):
                    api[f"{node.name}.{sub.name}"] = _params(sub)
    return api


def _modules(pkg: str):
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), pkg).replace(os.sep, "/")


def _port_api(module: str) -> dict:
    path = os.path.join(PORT_PKG, module)
    return public_api(path) if os.path.exists(path) else {}


def api_gaps() -> list:
    """Every JAX name or parameter the port lacks, outside the allow-lists."""
    gaps = []
    for module in sorted(_modules(JAX_PKG)):
        port = _port_api(module)
        for name, params in public_api(os.path.join(JAX_PKG, module)).items():
            key = f"{module}:{name}"
            if key in REPLACED:
                continue
            if name not in port:
                gaps.append(f"{key} is missing")
            elif params is not None:
                lacking = params - (port[name] or set()) - DROPPED.get(key, set())
                if lacking:
                    gaps.append(f"{key} lacks parameters {sorted(lacking)}")
    return gaps


def test_port_has_every_public_name_and_parameter():
    assert api_gaps() == []


@pytest.mark.parametrize("key", sorted(REPLACED))
def test_allow_list_entries_are_live(key):
    """Each replaced name still exists in the JAX package and not in the
    port, and its replacement exists in the port."""
    module, name = key.split(":")
    assert name in public_api(os.path.join(JAX_PKG, module))
    assert name not in _port_api(module)
    if REPLACED[key] is not None:
        r_module, r_name = REPLACED[key].split(":")
        assert r_name in _port_api(r_module)


@pytest.mark.parametrize("key", sorted(DROPPED))
def test_dropped_parameters_are_live(key):
    """Each dropped parameter is still a JAX parameter the port lacks."""
    module, name = key.split(":")
    jax_params = public_api(os.path.join(JAX_PKG, module))[name]
    port_params = _port_api(module)[name]
    assert DROPPED[key] <= jax_params and not DROPPED[key] & port_params


def test_parser_sees_methods_and_parameters():
    """The walk reads methods and every kind of parameter: a known class
    method and a known function's full signature."""
    api = public_api(os.path.join(JAX_PKG, "ops", "optimize.py"))
    assert api["minimize_bounded_chunked"] == {"fun", "x0", "lo", "hi", "max_iter", "tol",
                                               "memory_size", "linesearch", "chunk"}
    bicycle = public_api(os.path.join(JAX_PKG, "models", "bicycle.py"))
    assert bicycle["BicycleModel"] is None
    assert {"throttle", "vx", "rho", "alpha"} <= bicycle["BicycleModel.traction_ellipse"]
