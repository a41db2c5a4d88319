"""The port's public API against the JAX package's, by their source alone.

Both packages are parsed with `ast`; neither is imported, so this runs in
well under a second.  Every public (not underscore-prefixed) top-level
function and class of `lap_time_optimization_tpu/`, and every public method
of such a class, must exist under the same module path and name in
`lap_time_optimization_tpu_torch/`, and take every parameter name the JAX
one takes (the port may take more: `device`, `solver`, a generator).  Each
such function also keeps the JAX one's defaults (a parameter without a
default in JAX has none in the port) and its positional order (the JAX
positional parameters are the port's first ones, in order, so a call by
position lands in the same parameters), and each dataclass or NamedTuple
keeps the JAX one's fields, in order, with their defaults.  The only
exceptions are the allow-lists below, each with its reason.
"""

import ast
import os
import sys

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
    # Read by nothing; `Timer.report()` gives the first and steady times.
    "utils/profiling.py:solve_rate": None,
    "utils/profiling.py:Timer.compile_time": None,
    "utils/profiling.py:Timer.steady_time": None,
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


# Positional order: JAX functions whose positional parameters the port
# orders otherwise, with the reason.
REORDERED = {
    # JAX's own fit deletes key, n_restarts and max_iter unused; the port
    # leaves them out, so mask, ell0 and n_grid sit three places earlier.
    # Every caller in both packages passes them by name.
    "ops/gp.py:fit": "mask, ell0, n_grid follow y (JAX's unused key, n_restarts, max_iter are gone)",
    # `device` follows `dtype` as in torch's factories; a JAX-style positional
    # lateral_margin lands in `device`, where `.to()` raises on a float.
    "mpc/solver.py:OCPParams.reference": "device follows dtype, as in torch's factories",
}

# Fields of a JAX dataclass the port's counterpart does not have.
DROPPED_FIELDS = {
    # JAX/TPU knobs the port's single CUDA route has no use for: the XLA/
    # Pallas backend choice, the Pallas batch kernel's table window (the
    # CUDA kernel reads the whole table), and lax.scan unroll factors.
    "mpc/solver.py:SolverConfig": {"backend", "window", "unroll_horizon", "unroll_ilqr"},
}

# JAX pytree dataclasses the port makes `torch.nn.Module`s (their arrays are
# buffers that follow `.to(device, dtype)`): their fields are the module's
# constructor arguments, held by name (each field is a constructor
# parameter or a name in the module's source, such as its FIELDS tuple) and,
# where the constructor takes the field as a parameter with a default in
# both packages, by default.
MODULES = {
    "models/bicycle.py:BicycleModel",
    "models/vehicle.py:PointMassVehicle",
    "models/vehicle.py:PacejkaVehicle",
    "mpc/solver.py:OCPParams",
    "mpc/track.py:MPCTrack",
    "track.py:Track",
}


def _params(fn) -> set:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    names |= {f"*{v.arg}" for v in (a.vararg, a.kwarg) if v is not None}
    return names


FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _public(path: str):
    """(name or Class.method, its function node or, for a class, its class
    node) of the public top-level functions and classes at `path` and the
    public methods of those classes."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in tree.body:
        if not isinstance(node, (*FUNCS, ast.ClassDef)) or node.name.startswith("_"):
            continue
        yield node.name, node
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, FUNCS) and not sub.name.startswith("_"):
                    yield f"{node.name}.{sub.name}", sub


def public_api(path: str) -> dict:
    """{name or Class.method: parameter names (None for a class)} of the
    module at `path`."""
    return {name: None if isinstance(node, ast.ClassDef) else _params(node) for name, node in _public(path)}


def _default(node):
    """Source text of a default (None: no default); a dataclasses.field's
    `default`/`default_factory`, and jnp dtypes as torch's."""
    if node is None:
        return None
    if isinstance(node, ast.Call) and ast.unparse(node.func) in ("dataclasses.field", "field"):
        for kw in node.keywords:
            if kw.arg in ("default", "default_factory"):
                return _default(kw.value)
        return None
    return ast.unparse(node).replace("jnp.", "torch.")


def _signature(fn):
    """(positional parameter names in order, {name: default text or None})."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [_default(d) for d in a.defaults]
    named = dict(zip((p.arg for p in pos), defaults))
    named.update({p.arg: _default(d) for p, d in zip(a.kwonlyargs, a.kw_defaults)})
    return [p.arg for p in pos], named


def _is_record(node: ast.ClassDef) -> bool:
    """A dataclass or a NamedTuple."""
    return (any("dataclass" in ast.unparse(d) for d in node.decorator_list)
            or any(ast.unparse(b) in ("NamedTuple", "typing.NamedTuple") for b in node.bases))


def signatures(path: str) -> dict:
    """{name or Class.method: _signature} and {Class: (fields [(name,
    default)] if a dataclass or NamedTuple else None, constructor
    _signature or None)} of the public functions and classes at `path`."""
    if not os.path.exists(path):
        return {}
    out = {}
    for name, node in _public(path):
        if isinstance(node, FUNCS):
            out[name] = _signature(node)
            continue
        fields = [(n.target.id, _default(n.value)) for n in node.body
                  if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]
        init = next((_signature(n) for n in node.body if isinstance(n, FUNCS) and n.name == "__init__"), None)
        out[name] = (fields if _is_record(node) else None, init)
    return out


def _strings(path: str) -> set:
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _pairs():
    """(module, name, JAX entry, port entry) of every public JAX function,
    method and class the port has under the same name (outside REPLACED)."""
    for module in sorted(_modules(JAX_PKG)):
        port = signatures(os.path.join(PORT_PKG, module))
        for name, entry in signatures(os.path.join(JAX_PKG, module)).items():
            if f"{module}:{name}" not in REPLACED and name in port:
                yield module, name, entry, port[name]


def _is_class_entry(entry) -> bool:
    """A class's entry of `signatures` (a function's is (list, dict))."""
    return not (isinstance(entry[0], list) and isinstance(entry[1], dict))


def order_gaps() -> list:
    """JAX functions whose positional parameters are not the port's first
    ones, in order (a DROPPED parameter's slot may hold the port's stand-in)."""
    gaps = []
    for module, name, jax_entry, port_entry in _pairs():
        key = f"{module}:{name}"
        if _is_class_entry(jax_entry) or key in REORDERED:
            continue
        j_pos, p_pos = jax_entry[0], port_entry[0]
        drop = DROPPED.get(key, set())
        while j_pos and j_pos[-1] in drop:  # a dropped last parameter leaves no slot
            j_pos = j_pos[:-1]
        if len(p_pos) < len(j_pos) or any(j != p for j, p in zip(j_pos, p_pos) if j not in drop):
            gaps.append(f"{key}: positional {j_pos} in JAX, {p_pos} in the port")
    return gaps


def default_gaps() -> list:
    """Parameters whose default differs (or is missing on one side)."""
    gaps = []
    for module, name, jax_entry, port_entry in _pairs():
        key = f"{module}:{name}"
        if _is_class_entry(jax_entry):
            continue
        drop = DROPPED.get(key, set())
        for param, default in jax_entry[1].items():
            if param in drop or param not in port_entry[1]:
                continue
            if port_entry[1][param] != default:
                gaps.append(f"{key}({param}): default {default} in JAX, {port_entry[1][param]} in the port")
    return gaps


def field_gaps() -> list:
    """Dataclass and NamedTuple fields the port lacks, reorders or gives
    another default (MODULES: by name and constructor default)."""
    gaps = []
    for module, name, jax_entry, port_entry in _pairs():
        key = f"{module}:{name}"
        if not _is_class_entry(jax_entry) or jax_entry[0] is None:
            continue
        j_fields = [f for f in jax_entry[0] if f[0] not in DROPPED_FIELDS.get(key, set())]
        if key in MODULES:
            init = port_entry[1] or ([], {})
            known = set(init[1]) | _strings(os.path.join(PORT_PKG, module))
            missing = [f for f, _ in j_fields if f not in known]
            if missing:
                gaps.append(f"{key}: fields {missing} missing from the port's module")
            for field, default in j_fields:
                if default is not None and init[1].get(field) is not None and init[1][field] != default:
                    gaps.append(f"{key}.{field}: default {default} in JAX, {init[1][field]} in the port")
                elif default is not None and field in init[1] and init[1][field] is None:
                    gaps.append(f"{key}.{field}: default {default} in JAX, none in the port")
        elif port_entry[0] != j_fields:
            gaps.append(f"{key}: fields {j_fields} in JAX, {port_entry[0]} in the port")
    return gaps


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


ASPECTS = {"defaults": default_gaps, "positional order": order_gaps, "fields": field_gaps}


@pytest.mark.parametrize("aspect", sorted(ASPECTS))
def test_port_keeps_the_jax_signatures(aspect):
    """Defaults, positional order, and dataclass and NamedTuple fields with
    their defaults, as the JAX package has them (outside the allow-lists)."""
    assert ASPECTS[aspect]() == []


@pytest.mark.parametrize("key", sorted(REORDERED))
def test_reordered_entries_are_live(key):
    """Each reordered function still orders its positional parameters
    otherwise than JAX's."""
    module, name = key.split(":")
    jax_pos = signatures(os.path.join(JAX_PKG, module))[name][0]
    port_pos = signatures(os.path.join(PORT_PKG, module))[name][0]
    assert port_pos[:len(jax_pos)] != jax_pos


@pytest.mark.parametrize("key", sorted(DROPPED_FIELDS))
def test_dropped_fields_are_live(key):
    """Each dropped field is still a JAX field the port lacks."""
    module, name = key.split(":")
    jax_fields = {f for f, _ in signatures(os.path.join(JAX_PKG, module))[name][0]}
    port_fields = {f for f, _ in signatures(os.path.join(PORT_PKG, module))[name][0]}
    assert DROPPED_FIELDS[key] <= jax_fields and not DROPPED_FIELDS[key] & port_fields


@pytest.mark.parametrize("key", sorted(MODULES))
def test_module_entries_are_live(key):
    """Each MODULES class is a dataclass with fields in JAX and an
    nn.Module in the port."""
    module, name = key.split(":")
    assert signatures(os.path.join(JAX_PKG, module))[name][0]
    with open(os.path.join(PORT_PKG, module), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == name)
    assert any(ast.unparse(b) in ("nn.Module", "torch.nn.Module") for b in cls.bases)


JAX_SOURCE = """
import dataclasses
from typing import NamedTuple


def step(x, dt=0.1, *, substeps=2):
    pass


@dataclasses.dataclass(frozen=True)
class Config:
    horizon: int = dataclasses.field(metadata=dict(static=True), default=10)
    dtype: object = jnp.float32


class Result(NamedTuple):
    us: object
    cost: float = 0.0
"""

MUTATIONS = {
    "changed default": ("dt=0.1", "dt=0.2", default_gaps),
    "default removed": ("substeps=2", "substeps", default_gaps),
    "positional order": ("x, dt=0.1", "dt=0.1, x=None", order_gaps),
    "missing dataclass field": ("    dtype: object = torch.float32\n", "", field_gaps),
    "changed NamedTuple default": ("cost: float = 0.0", "cost: float = 1.0", field_gaps),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_checks_catch_a_mutation(mutation, tmp_path, monkeypatch):
    """A port module equal to its JAX module (dtypes as torch's) has no gap;
    one changed default, positional order or field makes exactly one."""
    old, new, finder = MUTATIONS[mutation]
    for pkg in ("jax", "port", "bad"):
        (tmp_path / pkg).mkdir()
    (tmp_path / "jax" / "m.py").write_text(JAX_SOURCE)
    port_source = JAX_SOURCE.replace("jnp.", "torch.")
    (tmp_path / "port" / "m.py").write_text(port_source)
    assert old in port_source
    (tmp_path / "bad" / "m.py").write_text(port_source.replace(old, new))
    monkeypatch.setattr(sys.modules[__name__], "JAX_PKG", str(tmp_path / "jax"))
    monkeypatch.setattr(sys.modules[__name__], "PORT_PKG", str(tmp_path / "port"))
    assert default_gaps() == order_gaps() == field_gaps() == []
    monkeypatch.setattr(sys.modules[__name__], "PORT_PKG", str(tmp_path / "bad"))
    assert len(finder()) == 1
