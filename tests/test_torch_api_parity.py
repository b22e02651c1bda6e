"""The port's public surface against the JAX package's, by AST alone.

Every public top-level function and class of each
`gaussianavatars_tpu/**/*.py`, every public method (and `__init__`) of
such a class and every parameter of those must have its namesake in the
port's module of the same path (`gaussianavatars_torch/...`), or an entry
in `BY_DESIGN` that names the port's counterpart (checked to exist) or
None, with its reason. Every `add_argument` flag of every `scripts/*.py`
but `convert.py` must have its namesake in the port's tool of the same
name, but for `BY_DESIGN_FLAGS`. Neither package is imported; the whole
file parses source text and takes well under a second.
"""
import ast
import functools
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "gaussianavatars_tpu"
PORT = ROOT / "gaussianavatars_torch"

# (JAX module path, name) → (the port's counterpart or None, the reason).
# A name is `f`, `Cls`, `Cls.meth`, `f(param)` or `Cls.meth(param)`, and its
# counterpart a name of the same form in the port's module of the same path.
# `*` stands for the whole module: its counterpart is the port's module that
# holds its names (checked as above), or None when none does.
BY_DESIGN = {
    ("native.py", "*"): (
        None, "the port decodes with PIL; the card's machine has no libpng headers"),
    ("ops/pallas/__init__.py", "*"): (
        None, "the Pallas kernels' package; the port's kernels live in csrc/ and "
              "their wrappers in ops/composite_pairs.py"),
    ("ops/pallas/composite_pairs.py", "*"): (
        "ops/composite_pairs.py", "the compositors' CUDA wrappers, beside their plain "
                                  "versions, in place of the Pallas kernels"),
    ("parallel/mesh.py", "make_device_mesh"): (
        "make_rank_mesh", "a mesh of torch.distributed ranks and their process groups, "
                          "not of jax devices"),
    ("parallel/distributed.py", "make_global_batch"): (
        None, "each rank holds its own tensors and reads its row's full ground truth; "
              "there is no global array to assemble"),
    ("training/trainer.py", "make_train_scan"): (
        "make_train_chunk", "K steps as one captured CUDA graph of the step, replayed K "
                            "times, in place of one lax.scan"),
    ("training/trainer.py", "make_train_step(jit)"): (
        None, "the step is eager autograd; captured CUDA graphs (TrainChunk, ShardedStep) "
              "take jit's place"),
    ("utils/debug.py", "checked(errors)"): (
        None, "no checkify error sets: the wrapper reports non-finite outputs only"),
    ("training/loss.py", "safe_norm(axis)"): ("safe_norm(dim)", "torch's name for the axis"),
    ("ops/sort_binning.py", "reduce_expansion(cols)"): (
        "reduce_expansion(x)", "the expansion gradients as a tensor named x"),
    ("data/pipeline.py", "Prefetcher.__init__(device_put)"): (
        "Prefetcher.__init__(device)", "the caller names the device the tensors go to"),
    ("metrics/lpips.py", "synthetic_lpips_params(key)"): (
        "synthetic_lpips_params(generator)", "random draws come from a torch.Generator"),
    ("models/densify.py", "densify_and_prune(key)"): (
        "densify_and_prune(generator)", "random draws come from a torch.Generator "
                                        "(or the normals as noise=)"),
    ("models/gaussians.py", "init_bound(key)"): (
        "init_bound(generator)", "random draws come from a torch.Generator"),
    ("training/innovations.py", "color_net_init(key)"): (
        "color_net_init(generator)", "random draws come from a torch.Generator"),
    ("training/loop.py", "build_harness(key)"): (
        "build_harness(generator)", "random draws come from a torch.Generator"),
    ("training/trainer.py", "init_train_state(key)"): (
        "init_train_state(generator)", "random draws come from a torch.Generator"),
    ("utils/profiling.py", "StepTimer"): (
        None, "an EMA of host ms a step that nothing called; the stage clock "
              "(enable_stage_clock, annotate, stage_report) times steps on the card"),
}

# (script, flag) → the reason the port's tool has no such flag.
BY_DESIGN_FLAGS = {
    ("scaling_bench.py", "--cpu"): "JAX's virtual CPU devices; the port takes --device",
    ("scaling_bench.py", "--capacity"): "the port's --per_face sizes the avatar",
}
SCRIPTS_NOT_PORTED = {"convert.py"}  # drives the colmap binaries; serves both packages


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name: str) -> bool:
    return not name.startswith("_")


class Module:
    """A module's top-level functions, classes (with their methods) and the
    names it imports, from its source."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self.defs, self.classes, self.imports = {}, {}, {}
        if not path.exists():
            return
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
            elif isinstance(node, ast.ImportFrom) and node.level:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (node.level, node.module,
                                                                alias.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.imports.setdefault(t.id, None)

    def function(self, name: str):
        """The FunctionDef of `name`, following relative imports in the port."""
        if name in self.defs:
            return self.defs[name]
        src = self.imports.get(name)
        if src:
            level, module, orig = src
            base = self.path.parent
            for _ in range(level - 1):
                base = base.parent
            target = base.joinpath(*(module or "").split(".")).with_suffix(".py")
            return _module(target).function(orig)
        return None

    def has(self, name: str) -> bool:
        return name in self.defs or name in self.classes or name in self.imports

    def methods(self, cls: str) -> dict:
        """Methods of `cls`, with those of its bases defined in this module."""
        out = {}
        node = self.classes.get(cls)
        if node is None:
            return out
        for base in node.bases:
            if isinstance(base, ast.Name) and base.id in self.classes:
                out.update(self.methods(base.id))
        for b in node.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[b.name] = b
        return out


@functools.lru_cache(maxsize=None)
def _module(path: pathlib.Path) -> Module:
    return Module(path)


def _port(rel: str) -> Module:
    """The port's module that holds the names of JAX's module `rel`."""
    if (rel, "*") in BY_DESIGN:
        rel = BY_DESIGN[(rel, "*")][0]
    return _module(PORT / rel)


def _exists(mod: Module, name: str) -> bool:
    """Whether `f`, `Cls`, `Cls.meth`, `f(p)` or `Cls.meth(p)` is in `mod`."""
    param = None
    if name.endswith(")"):
        name, param = name[:-1].split("(")
    if "." in name:
        cls, meth = name.split(".")
        fn = mod.methods(cls).get(meth)
    else:
        fn = mod.function(name)
        if fn is None and param is None:
            return mod.has(name)
    return fn is not None and (param is None or param in _params(fn))


def _jax_surface():
    """(rel path, name, kind) of every public function, class, method and
    parameter of the JAX package, kind in {"module", "name", "param"}."""
    for path in sorted(JAX.rglob("*.py")):
        rel = path.relative_to(JAX).as_posix()
        yield rel, "*", "module"
        mod = Module(path)
        for name, fn in mod.defs.items():
            if _public(name):
                yield rel, name, "name"
                for p in _params(fn):
                    yield rel, f"{name}({p})", "param"
        for name in mod.classes:
            if not _public(name):
                continue
            yield rel, name, "name"
            for meth, fn in mod.methods(name).items():
                if _public(meth) or meth == "__init__":
                    yield rel, f"{name}.{meth}", "name"
                    for p in _params(fn):
                        yield rel, f"{name}.{meth}({p})", "param"


def test_every_public_name_method_and_parameter_has_its_port_counterpart():
    missing, wrong_counterpart, used = [], [], set()
    for rel, name, kind in _jax_surface():
        if (rel, "*") in BY_DESIGN:
            used.add((rel, "*"))
            if BY_DESIGN[(rel, "*")][0] is None:
                continue
        if kind == "module":
            if not _port(rel).path.exists():
                missing.append(f"{rel}: the module")
            continue
        owner = name.split("(")[0]
        if kind == "param" and (rel, owner) in BY_DESIGN:
            continue  # the whole function or method is accounted for
        if "." in owner and (rel, owner.split(".")[0]) in BY_DESIGN:
            continue
        if (rel, name) in BY_DESIGN:
            used.add((rel, name))
            counterpart, _reason = BY_DESIGN[(rel, name)]
            if counterpart is not None and not _exists(_port(rel), counterpart):
                wrong_counterpart.append(f"{rel}: {name} → {counterpart}")
            continue
        if not _exists(_port(rel), name):
            missing.append(f"{rel}: {name}")
    stale = [f"{rel}: {name}" for rel, name in sorted(set(BY_DESIGN) - used)]
    faults = {"the port lacks": missing,
              "BY_DESIGN names counterparts the port lacks": wrong_counterpart,
              "BY_DESIGN entries that match nothing in the JAX package": stale}
    assert not any(faults.values()), "\n".join(
        f"{what}:\n  " + "\n  ".join(items) for what, items in faults.items() if items)


def _flags(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return out


def test_every_script_flag_has_its_namesake_in_the_port_tool():
    missing, used = [], set()
    for script in sorted((ROOT / "scripts").glob("*.py")):
        if script.name in SCRIPTS_NOT_PORTED:
            continue
        tool = PORT / "tools" / script.name
        if not tool.exists():
            missing.append(f"{script.name}: the tool")
            continue
        have = _flags(tool)
        for flag in sorted(_flags(script)):
            if (script.name, flag) in BY_DESIGN_FLAGS:
                used.add((script.name, flag))
            elif flag not in have:
                missing.append(f"{script.name}: {flag}")
    assert not missing, "the port's tools lack:\n  " + "\n  ".join(missing)
    assert used == set(BY_DESIGN_FLAGS), f"stale: {set(BY_DESIGN_FLAGS) - used}"


def test_by_design_entries_give_a_reason():
    assert all(reason.strip() for _c, reason in BY_DESIGN.values())
    assert all(reason.strip() for reason in BY_DESIGN_FLAGS.values())


def _module_level_calls(path: pathlib.Path) -> set:
    return {node.value.func.id for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Name)}


def test_tools_bootstrap_the_template_where_the_scripts_do():
    """The scripts that point $GSAVATARS_FLAME_TEMPLATE at a local real
    template on import (`bootstrap_template_env()`) have port tools that do."""
    scripts = [s.name for s in sorted((ROOT / "scripts").glob("*.py"))
               if "bootstrap_template_env" in _module_level_calls(s)]
    assert scripts, "no script bootstraps the template"
    lacking = [s for s in scripts
               if "bootstrap_template_env" not in _module_level_calls(PORT / "tools" / s)]
    assert not lacking, f"tools that do not bootstrap the template: {lacking}"
