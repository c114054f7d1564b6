"""The port covers hpfw_tpu's public surface, apart from BY_DESIGN.

For every module of hpfw_tpu (and __graft_entry__, whose counterpart is
hpfw_tpu_torch.graft_entry), each public name the module defines needs a
counterpart of that name in the same-named module of hpfw_tpu_torch; a
callable's parameters must include the reference's, and a public class needs
every public attribute and method of the reference's class, each method's
parameters including the reference method's. Every gap the port keeps is a
BY_DESIGN entry with its reason. A gap that is not listed fails its module's
case, and so does a listed entry that is no longer a gap. Imports only.

Keys: "mod" (the whole module has no counterpart), "mod:name",
"mod:Class.method", and "mod:callable(param)" for a missing parameter; mod is
the module's name under hpfw_tpu ("" for the package itself).
"""

import ast
import importlib
import inspect
import pkgutil
import types

import pytest

import hpfw_tpu

CODEC = "a pure-NumPy codec; the port decodes natively and raises where hpfw_tpu falls back to it"
CODEC_TABLES = "tables of the pure-NumPy codecs, which the port does not carry"
CODEC_PROBE = "a probe of a pure-NumPy codec against its reference decoder"
KERNEL = "a Pallas kernel's module; its kernel is hpfw_tpu_torch/csrc (K1-K5), ROADMAP B"
PALLAS = "a route selector between the TPU's Pallas kernels and XLA; the port's route is the device"
INTERPRET = "runs a Pallas kernel in interpret mode; the port's plain versions run on the CPU"

BY_DESIGN = {
    # Modules with no counterpart.
    **{f"io.{m}": CODEC for m in ("mp3", "aac", "flac", "vorbis", "opus", "ogg", "mp3enc")},
    **{f"io.{m}": CODEC_TABLES for m in (
        "_aac_tables", "_celt_bands", "_celt_ec", "_celt_energy", "_celt_frame",
        "_celt_pvq", "_celt_tables", "_mp3_huffman", "_mp3_layer2", "_mp3_layer3",
        "_mpeg_l2_tables", "_mpeg_window")},
    **{f"io.{m}": CODEC_PROBE for m in ("aac_ref", "mpeg_ref", "opus_ref", "vorbis_ref")},
    "io.synth_jax": "the device synthesizer in JAX; its counterpart is io/synth_device.py",
    "utils.cache": "XLA's persistent compile cache; the port compiles nothing per shape",
    **{f"ops.pallas_{m}": KERNEL for m in ("frontend", "fingerprint", "match", "coarse", "fine")},
    # Parameters: the TPU's route selectors.
    **{f"api:{f}(use_pallas)": PALLAS for f in (
        "fingerprint", "fingerprint_batch", "fingerprint_stream", "build_db",
        "build_db_from_files")},
    "artist:ArtistDB.build(use_pallas)": PALLAS,
    "artist:ArtistDB(use_pallas_fine)": PALLAS,
    "artist:ArtistDB(pallas_interpret)": INTERPRET,
    "match.scaled:TwoStageDB(use_pallas_fine)": PALLAS,
    "match.scaled:TwoStageDB(use_pallas_coarse)": PALLAS,
    "match.scaled:TwoStageDB(pallas_interpret)": INTERPRET,
    "match.scaled:TwoStageDB(coarse_tile)":
        "the Pallas coarse kernel's track tile; the port's tile is 8 tracks (ROADMAP C)",
    "match.scaled:TwoStageDB.load(pallas_interpret)": INTERPRET,
    "match.scaled:TwoStageDB.load(install_cache)":
        "installs bundled XLA compile-cache entries; the port has none to install",
    "match.matcher:score_tracks(offset_block)":
        "the XLA scan's offset block; K3 and its plain version tile offsets themselves",
    "ops.fused:fingerprint(interpret)": INTERPRET,
    "ops.coarse:coarse_pm1(dtype)":
        "the XLA conv's operand type; the port's coarse prints are always int8",
    "match.sharded:sharded_score(prints)":
        "jax arrays sharded over a mesh; the port takes a list of per-device shards",
    "match.sharded:sharded_score(lengths)":
        "jax arrays sharded over a mesh; the port takes a list of per-device shards",
    # JAX helpers.
    "parallel.mesh:DB_AXIS": "the name of a JAX mesh axis; the port's Mesh is a device list",
    "parallel.mesh:shard_spec": "a JAX PartitionSpec; the port splits tracks with split_tracks",
    "parallel.mesh:replicated_spec": "a JAX PartitionSpec; the port copies to each device",
    "parallel.mesh:track_sharding": "a JAX NamedSharding; the port splits tracks with split_tracks",
    "parallel.mesh:replicated_sharding": "a JAX NamedSharding; the port copies to each device",
    "ops.dot:precise_dot":
        "a jnp.dot at HIGHEST precision; the port's is dot.precise_matmul with TF32 off",
    "ops.fused:filters_pad_split":
        "the Pallas encoder's filter split; K2's split pass does it on the card",
}


def _modules():
    """(reference module name, port module name, key prefix)."""
    names = ["hpfw_tpu"] + sorted(m.name for m in pkgutil.walk_packages(hpfw_tpu.__path__,
                                                                         "hpfw_tpu."))
    out = [(n, "hpfw_tpu_torch" + n[len("hpfw_tpu"):], n[len("hpfw_tpu."):]) for n in names]
    return out + [("__graft_entry__", "hpfw_tpu_torch.graft_entry", "__graft_entry__")]


MODULES = _modules()


def _defined(mod) -> list[str]:
    """The public names a module's own top level defines (def, class,
    assignment), not the ones it imports."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _params(fn) -> list[str]:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    return [p for p in sig.parameters if p not in ("self", "cls")]


def _missing_params(key: str, ref, port) -> list[str]:
    have = set(_params(port))
    return [f"{key}({p})" for p in _params(ref) if p not in have]


def gaps(ref, port, prefix: str, names=None) -> set[str]:
    """The keys of every reference name, class member or parameter that the
    port module lacks (port None: the module itself is missing)."""
    if port is None:
        return {prefix}
    p = f"{prefix}:"
    out = set()
    for name in names if names is not None else _defined(ref):
        r = getattr(ref, name)
        if not hasattr(port, name):
            out.add(p + name)
            continue
        q = getattr(port, name)
        if inspect.isclass(r):
            out.update(_missing_params(p + name, r, q))
            for m in vars(r):
                if m.startswith("_"):
                    continue
                if not hasattr(q, m):
                    out.add(f"{p}{name}.{m}")
                elif callable(getattr(r, m)):
                    out.update(_missing_params(f"{p}{name}.{m}", getattr(r, m), getattr(q, m)))
        elif callable(r):
            out.update(_missing_params(p + name, r, q))
    return out


def _owned(prefix: str) -> set[str]:
    return {k for k in BY_DESIGN if k == prefix or k.startswith(prefix + ":")}


@pytest.mark.parametrize("ref_name,port_name,prefix", MODULES, ids=[m[2] or "hpfw_tpu"
                                                                    for m in MODULES])
def test_module_surface(ref_name, port_name, prefix):
    ref = importlib.import_module(ref_name)
    try:
        port = importlib.import_module(port_name)
    except ModuleNotFoundError as e:
        if e.name != port_name:
            raise
        port = None
    found = gaps(ref, port, prefix)
    assert not found - BY_DESIGN.keys(), f"missing in {port_name}: {sorted(found - BY_DESIGN.keys())}"
    assert not _owned(prefix) - found, f"listed but ported: {sorted(_owned(prefix) - found)}"


def test_every_exception_names_a_module():
    prefixes = {m[2] for m in MODULES}
    assert all(k.split(":")[0] in prefixes for k in BY_DESIGN)
    assert all(reason.strip() for reason in BY_DESIGN.values())


def test_gaps_finds_each_kind():
    """The checker itself: a missing name, method, class attribute and
    parameter are each found, and a covering port shows none."""
    def f(a, b=1):
        pass

    class C:
        def __init__(self, x, y=0):
            pass

        def m(self, q, *, k=None):
            pass

        attr = 1

    ref = types.SimpleNamespace(f=f, C=C, K=3)

    def g(a):
        pass

    class D:
        def __init__(self, x):
            pass

        def m(self, q):
            pass

    names = ["f", "C", "K"]
    assert gaps(ref, types.SimpleNamespace(f=g, C=D), "x", names) == {
        "x:f(b)", "x:C(y)", "x:C.m(k)", "x:C.attr", "x:K"}
    assert gaps(ref, types.SimpleNamespace(f=f, C=C, K=0), "x", names) == set()
    assert gaps(ref, None, "x", names) == {"x"}
