"""
The PyTorch port's public surface against the JAX package's, read from
the sources with ast alone: neither package is imported, so this file
needs no JAX and takes a second or two.

  * Every public module-level function and class, and every public method,
    of every module of libdmet_preview_tpu/ and of __graft_entry__.py
    (there its private helpers too: the file is the JAX package's driver
    surface) has a counterpart of the same name in the same relative
    module of libdmet_preview_tpu_torch/ (__graft_entry__.py -> entry.py),
    or where RENAMES puts it.
  * Each counterpart accepts every parameter name of the JAX definition,
    by name or through **kwargs, and requires no argument that the JAX
    definition does not take (so the JAX package's keyword calls run).
  * EXCEPTIONS holds what is not ported, each entry with its reason.
  * No module of the port, chip_smoke.py or examples/torch/*.py imports
    jax or libdmet_preview_tpu.

One case per JAX module, so that a regression names its module.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "libdmet_preview_tpu")
PORT_PKG = os.path.join(REPO, "libdmet_preview_tpu_torch")
ENTRY = "__graft_entry__.py"

# (JAX module, name) -> (port module, name, {JAX parameter: port parameter})
RENAMES = {
    ("ops/pallas_eri.py", "syrk_df"): ("ops/eri_kernels.py", "syrk_df", {}),
    ("ops/pallas_eri.py", "pack_tril"): ("ops/eri_kernels.py", "pack_tril",
                                         {}),
    ("ops/pallas_eri.py", "unpack_s4"): ("ops/eri_kernels.py", "unpack_s4",
                                         {}),
    ("ops/pallas_eri.py", "eri_from_df_pallas"): (
        "ops/eri_kernels.py", "eri_from_df", {}),
    ("ops/pallas_eri.py", "get_emb_eri_chol_pallas"): (
        "ops/eri_transform.py", "get_emb_eri_chol", {"chol_L": "L"}),
}

_F64_EIGH = "TPU workaround: f32-seeded refined eigh; CUDA has f64 eigh"
_PAIR = ("TPU workaround: (re, im) pair algebra; CUDA has complex128 "
         "(ops/fourier.R2k / k2R take pairs and tensors)")
_JNP = "jit-safe jnp copy of a host function; the port's is torch already"
_SPLIT = "TPU workaround: hi/lo f32 operand split; the kernel is f64 DMMA"
_INTERPRET = "the Pallas interpreter's switch; a CUDA kernel has none"

# (JAX module, name): the definition is not ported;
# (JAX module, name, parameter): a JAX parameter the port does not take,
# or a parameter the port requires that the JAX definition lacks
EXCEPTIONS = {
    ("ops/zlinalg.py", "zeigh_refined"): _F64_EIGH,
    ("ops/zlinalg.py", "eigh_refined_real"): _F64_EIGH,
    ("ops/zlinalg.py", "rho_fermi_real_ws"): _F64_EIGH,
    ("ops/zlinalg.py", "zpair"): _PAIR,
    ("ops/zlinalg.py", "to_complex"): _PAIR,
    ("ops/zlinalg.py", "zmatmul"): _PAIR,
    ("ops/zlinalg.py", "R2k"): _PAIR,
    ("ops/zlinalg.py", "k2R"): _PAIR,
    ("ops/ftsystem.py", "fermi_occ_jnp"): _JNP,
    ("ops/ftsystem.py", "find_mu_jnp"): _JNP,
    ("utils/misc.py", "add_spin_dim_jnp"): _JNP,
    ("lo/wannier.py", "jnp_asarray"): _JNP,
    ("ops/pallas_eri.py", "split_f32"): _SPLIT,
    ("ops/pallas_eri.py", "dot_split"): _SPLIT,
    ("ops/pallas_eri.py", "syrk_df", "interpret"): _INTERPRET,
    ("ops/pallas_eri.py", "eri_from_df_pallas", "interpret"): _INTERPRET,
    ("ops/pallas_eri.py", "get_emb_eri_chol_pallas", "interpret"):
        _INTERPRET,
    (ENTRY, "_dryrun_multichip_inline"):
        "legacy in-process fallback of dryrun_multichip, which is ported",
    ("parallel/kmesh.py", "make_zrho_fermi_sharded", "mesh"):
        "a rank's process groups are an explicit Mesh; JAX binds the axis "
        "by the enclosing shard_map",
}


def _jax_modules():
    mods = []
    for root, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(root, f), JAX_PKG))
    return sorted(mods) + [ENTRY]


def _jax_path(mod):
    return os.path.join(REPO, ENTRY) if mod == ENTRY \
        else os.path.join(JAX_PKG, mod)


def _port_path(mod):
    return os.path.join(PORT_PKG, "entry.py" if mod == ENTRY else mod)


def _parse(path):
    with open(path) as fh:
        return ast.parse(fh.read(), filename=path)


def _definitions(tree):
    """{name: node} of the module-level functions and classes, and
    {"Class.method": node} of the methods each class defines."""
    defs = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defs[node.name] = node
        if isinstance(node, ast.ClassDef):
            defs.update(("%s.%s" % (node.name, m.name), m) for m in node.body
                        if isinstance(m, ast.FunctionDef))
    return defs


def _signature(node, defs):
    """(parameter names, takes **kwargs, required names) of a function,
    or of a class's __init__; None for a class without one."""
    if isinstance(node, ast.ClassDef):
        node = defs.get(node.name + ".__init__")
        if node is None:
            return None
    a = node.args
    pos = a.posonlyargs + a.args
    names = {x.arg for x in pos + a.kwonlyargs}
    required = {x.arg for x in pos[:len(pos) - len(a.defaults)]}
    required |= {x.arg for x, d in zip(a.kwonlyargs, a.kw_defaults)
                 if d is None}
    return names, a.kwarg is not None, required - {"self", "cls"}


def _public(name, mod):
    if mod == ENTRY and "." not in name:
        return True
    return all(not p.startswith("_") or (p.startswith("__")
                                         and p.endswith("__"))
               for p in name.split("."))


_PORT_DEFS = {}


def _port_defs(mod):
    if mod not in _PORT_DEFS:
        path = _port_path(mod)
        _PORT_DEFS[mod] = (_definitions(_parse(path))
                           if os.path.exists(path) else {})
    return _PORT_DEFS[mod]


def _gaps(mod):
    jdefs = _definitions(_parse(_jax_path(mod)))
    gaps = []
    for name, node in sorted(jdefs.items()):
        if not _public(name, mod) or (mod, name) in EXCEPTIONS:
            continue
        where, pname, pmap = RENAMES.get((mod, name), (mod, name, {}))
        pdefs = _port_defs(where)
        if pname not in pdefs:
            gaps.append("%s: no %s in the port's %s" % (name, pname, where))
            continue
        jsig = _signature(node, jdefs)
        psig = _signature(pdefs[pname], pdefs)
        if jsig is None:
            continue
        if psig is None:
            gaps.append("%s: the port's %s has no __init__" % (name, pname))
            continue
        jnames = jsig[0]
        pnames, pkwargs, prequired = psig
        for p in sorted(jnames - {"self", "cls"}):
            if (mod, name, p) in EXCEPTIONS or pkwargs:
                continue
            if pmap.get(p, p) not in pnames:
                gaps.append("%s: the port's %s does not take %s="
                            % (name, pname, pmap.get(p, p)))
        mapped = {pmap.get(p, p) for p in jnames}
        for p in sorted(prequired - mapped):
            if (mod, name, p) not in EXCEPTIONS:
                gaps.append("%s: the port's %s requires %s, which the JAX "
                            "definition does not take" % (name, pname, p))
    return gaps


@pytest.mark.parametrize("mod", _jax_modules())
def test_port_takes_every_public_name_and_parameter(mod):
    gaps = _gaps(mod)
    assert not gaps, "%s:\n  %s" % (mod, "\n  ".join(gaps))


def test_every_exception_and_rename_names_a_jax_definition():
    """A stale entry (a name the JAX package no longer has, or one the
    port has ported since) fails here."""
    for key in list(EXCEPTIONS) + list(RENAMES):
        mod, name = key[:2]
        jdefs = _definitions(_parse(_jax_path(mod)))
        assert name in jdefs, key
        if len(key) == 2 and key in EXCEPTIONS:
            assert name not in _port_defs(mod), (key, "is ported")
        if len(key) == 3:
            jnames = _signature(jdefs[name], jdefs)[0]
            port = RENAMES.get((mod, name), (mod, name, {}))
            pdefs = _port_defs(port[0])
            pnames, pkwargs, prequired = _signature(pdefs[port[1]], pdefs)
            if key[2] in jnames:        # a JAX parameter the port lacks
                assert key[2] not in pnames and not pkwargs, key
            else:                       # one the port requires
                assert key[2] in prequired, key


def _imports(path):
    """The top-level package names that a file imports, by import
    statements and by importlib.import_module / __import__ of a string."""
    names = set()
    for node in ast.walk(_parse(path)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if fname in ("import_module", "__import__"):
                names.add(node.args[0].value.split(".")[0])
    return names


def _port_files():
    out = []
    for root, _, files in os.walk(PORT_PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


_FILE_GROUPS = {
    "libdmet_preview_tpu_torch": _port_files,
    "chip_smoke.py": lambda: [os.path.join(REPO, "chip_smoke.py")],
    "examples/torch": lambda: sorted(
        os.path.join(REPO, "examples", "torch", f)
        for f in os.listdir(os.path.join(REPO, "examples", "torch"))
        if f.endswith(".py")),
}


@pytest.mark.parametrize("group", sorted(_FILE_GROUPS))
def test_no_jax_import(group):
    files = _FILE_GROUPS[group]()
    assert files
    bad = {os.path.relpath(f, REPO): sorted(
        _imports(f) & {"jax", "jaxlib", "libdmet_preview_tpu"})
        for f in files}
    assert not {k: v for k, v in bad.items() if v}
