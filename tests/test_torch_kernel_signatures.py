"""Each kernel wrapper's ctypes argument list matches its C entry point.

The port's kernels are C functions (``extern "C" int`` in
``deepspeed_tpu_torch/csrc/*.cu``) loaded with ctypes, so nothing checks
their argument lists at build time: a wrapper that passes one argument
too few, or an ``int`` where the function takes a ``long long``, is
undefined behaviour on the card and silent here.  These tests parse every
entry point's signature from its source and hold it against the
``argtypes`` its wrapper hands ``build.function``, found by reading the
wrapper modules (``ops/kernels/*.py``): every ``build.function(source,
argtypes[, symbol])`` call, with ``self.*`` arguments resolved through the
module's wrapper objects.  ``ds_error_string`` (``common.cuh``) is held
against the declaration ``build.check_status`` makes.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest

from deepspeed_tpu_torch.ops.kernels import build

KERNELS_DIR = Path(build.__file__).resolve().parent
CSRC = build.CSRC

#: C parameter types (pointers aside) and the ctypes type each must get
C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
           "long long": ctypes.c_longlong,
           "unsigned long long": ctypes.c_ulonglong, "float": ctypes.c_float}


def _c_kind(param: str):
    """The ctypes type a C parameter declaration needs."""
    decl = re.sub(r"\bconst\b", " ", param)
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()[:-1]                     # drop the parameter name
    return C_TYPES[" ".join(words)]


def c_entry_points():
    """{symbol: (source stem, [ctypes type per parameter])} of every
    ``extern "C" int`` function in ``csrc/*.cu``."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",")]
            out[m.group(1)] = (path.stem, [_c_kind(p) for p in params])
    return out


def _literal(node, module, obj=None):
    """The value of a ``build.function`` argument: a constant, a module
    name, or ``self.<attr>`` of the wrapper object ``obj``."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return getattr(module, node.id)
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self" and obj is not None:
        return getattr(obj, node.attr)
    raise AssertionError(f"{module.__name__}: cannot resolve "
                         f"{ast.dump(node)}")


def wrapper_bindings():
    """{symbol: (source, argtypes, where)} of every ``build.function``
    call in the wrapper modules; a call through ``self`` is resolved for
    each module-level wrapper object whose class defines those
    attributes."""
    out = {}
    for path in sorted(KERNELS_DIR.glob("*.py")):
        if path.stem in ("__init__", "build"):
            continue
        module = importlib.import_module(
            f"deepspeed_tpu_torch.ops.kernels.{path.stem}")
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "function"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "build"):
                continue
            via_self = any(isinstance(a, ast.Attribute)
                           and isinstance(a.value, ast.Name)
                           and a.value.id == "self" for a in node.args)
            objs = [None]
            if via_self:
                objs = [o for o in vars(module).values()
                        if not isinstance(o, type)
                        and getattr(type(o), "symbol", "")
                        and getattr(type(o), "argtypes", None)]
                assert objs, f"{path.name}:{node.lineno}: no wrapper object"
            for obj in objs:
                args = [_literal(a, module, obj) for a in node.args]
                source, argtypes = args[0], args[1]
                symbol = args[2] if len(args) > 2 else source
                where = f"{path.name}:{node.lineno}" + (
                    f" ({type(obj).__name__})" if obj is not None else "")
                assert symbol not in out or out[symbol][:2] == (
                    source, argtypes), f"{symbol} bound twice, differently"
                out[symbol] = (source, argtypes, where)
    return out


ENTRY_POINTS = c_entry_points()


def test_every_entry_point_is_found():
    # the 19 C entry points of the port's kernels
    assert len(ENTRY_POINTS) == 19, sorted(ENTRY_POINTS)


@pytest.mark.parametrize("symbol", sorted(ENTRY_POINTS))
def test_wrapper_argtypes_match_c_signature(symbol):
    bindings = wrapper_bindings()
    assert symbol in bindings, f"no wrapper calls build.function on {symbol}"
    source, argtypes, where = bindings[symbol]
    c_source, c_types = ENTRY_POINTS[symbol]
    assert source == c_source, (f"{where}: {symbol} is in {c_source}.cu, "
                                f"loaded from {source}")
    assert len(argtypes) == len(c_types), (
        f"{where}: {len(argtypes)} argtypes for {symbol}'s "
        f"{len(c_types)} parameters")
    for i, (got, want) in enumerate(zip(argtypes, c_types)):
        assert got is want, (f"{where}: {symbol} parameter {i} is "
                             f"{want.__name__}, the wrapper passes "
                             f"{got.__name__}")


def c_parameter_names():
    """{symbol: [parameter name]} of every ``extern "C" int`` function."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             path.read_text()):
            out[m.group(1)] = [p.split()[-1].lstrip("*")
                               for p in m.group(2).split(",")]
    return out


#: the entry points that take the TPU kernels' band and ALiBi options as
#: launch arguments: (symbol, options)
OPTION_ENTRY_POINTS = [
    ("flash_fwd", ("window",)),
    ("flash_bwd_dq", ("window",)),
    ("flash_bwd_dkv", ("window",)),
    ("flash_bwd_fused", ("window",)),
    ("decode_attn", ("window", "slopes")),
    ("decode_attn_int8", ("window", "slopes")),
    ("chunk_attn", ("window", "slopes")),
    ("chunk_attn_int8", ("window", "slopes"))]


@pytest.mark.parametrize("symbol,options", OPTION_ENTRY_POINTS)
def test_option_launch_arguments(symbol, options):
    """``window`` is an ``int`` (0 for none) and ``slopes`` a pointer
    (null for none) in the C interface, and the wrapper passes them at
    those positions with those types."""
    names = c_parameter_names()[symbol]
    argtypes = wrapper_bindings()[symbol][1]
    want = {"window": ctypes.c_int, "slopes": ctypes.c_void_p}
    for opt in options:
        assert opt in names, f"{symbol} takes no {opt}: {names}"
        i = names.index(opt)
        assert ENTRY_POINTS[symbol][1][i] is want[opt]
        assert argtypes[i] is want[opt], (symbol, opt, argtypes[i])


def test_every_wrapper_binds_an_entry_point():
    extra = set(wrapper_bindings()) - set(ENTRY_POINTS)
    assert not extra, f"wrappers bind symbols no source defines: {extra}"


def test_error_string_declaration(monkeypatch):
    """``ds_error_string(int)`` returns ``const char*``: check_status
    declares it so before raising."""
    text = (CSRC / "common.cuh").read_text()
    m = re.search(r'extern "C" const char\* ds_error_string\(([^)]*)\)', text)
    assert m, "ds_error_string not found in common.cuh"
    want = [_c_kind(p.strip()) for p in m.group(1).split(",")]

    class _Fn:
        argtypes = restype = None

        def __call__(self, status):
            return b"fake error"

    class _Lib:
        ds_error_string = _Fn()

    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    with pytest.raises(RuntimeError, match="fake error"):
        build.check_status("spatial", 1)
    assert lib.ds_error_string.argtypes == want
    assert lib.ds_error_string.restype is ctypes.c_char_p
