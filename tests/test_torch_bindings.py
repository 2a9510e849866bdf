"""The ctypes signatures of nd_tpu_torch's kernel wrappers against the C
entry points of its CUDA sources, on the CPU: every
``_build.function(name, signature)`` in ``nd_tpu_torch/ops`` must give
one letter per argument of ``name``'s declaration in
``nd_tpu_torch/csrc`` (p pointer, i int, q long long, d double, f
float). A wrong count or type only shows on the card otherwise, where
ctypes refuses the call or cuts a pointer."""

import ast
import re
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / 'nd_tpu_torch'


def _c_entry_points():
    decls = {}
    for src in sorted((PKG / 'csrc').glob('*.cu')):
        text = src.read_text()
        start = text.find('extern "C" {')
        if start < 0:          # a unit of template instantiations only
            continue
        body = text[start:]
        for m in re.finditer(r'^(?:int|long long|const char\*) (nd_\w+)\('
                             r'([^)]*)\)\s*\{', body, re.M):
            args = [a.strip() for a in m.group(2).split(',') if a.strip()]
            letters = ''
            for a in args:
                if '*' in a:
                    letters += 'p'
                elif a.startswith('long long'):
                    letters += 'q'
                elif a.startswith('double'):
                    letters += 'd'
                elif a.startswith('float'):
                    letters += 'f'
                elif a.startswith('int'):
                    letters += 'i'
                else:
                    raise AssertionError('unknown C type %r in %s' % (a, src))
            decls[m.group(1)] = letters
    return decls


def _bindings():
    """(module, C name, signature) of every _build.function call."""
    found = []
    for mod in sorted((PKG / 'ops').glob('*.py')):
        lines = mod.read_text().splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"_build\.function\((\w+|'\w+'),\s*(.+?)\)(\(|$)",
                          line)
            if not m:
                continue
            sig = ast.literal_eval(m.group(2)) if '+' not in m.group(2) \
                else eval(m.group(2), {})          # a literal expression
            if m.group(1).startswith("'"):
                names = [m.group(1).strip("'")]
            else:              # name = 'nd_..._f32' if ... else 'nd_..._f64'
                names = re.findall(r"'(nd_\w+)'",
                                   '\n'.join(lines[max(0, i - 4):i]))
            assert names, (mod.name, line)
            found += [(mod.name, n, sig) for n in names]
    return found


def test_every_kernel_wrapper_is_bound():
    bound = {name for _, name, _ in _bindings()}
    assert {'nd_sepconv_f32', 'nd_sepconv_f64', 'nd_sepconv3_f32',
            'nd_sepconv3_f64', 'nd_nlmeans_f32', 'nd_nlmeans_f64',
            'nd_omnibus_f32', 'nd_omnibus_scan_f32', 'nd_omnibus_mixed',
            'nd_omnibus_mixed_grid', 'nd_stream_plus_one_f32',
            'nd_stencil_f32', 'nd_stencil_f64', 'nd_stencil_tiled'} <= bound


@pytest.mark.parametrize('module,name,signature', _bindings())
def test_binding_matches_the_c_declaration(module, name, signature):
    decls = _c_entry_points()
    assert name in decls, '%s binds %s, which no source declares' % (
        module, name)
    assert signature == decls[name], (module, name)
