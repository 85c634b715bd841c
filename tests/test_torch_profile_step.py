"""tools/profile_step.py attributes every hand kernel to engine stages.

Every __global__ function of flybody_tpu_torch/csrc/*.cu, parsed here from
the sources, maps to exactly one HAND_KERNELS entry by its exact name
(template arguments stripped), in the demangled and the mangled forms the
profiler may give; each stage split sums to 1 at every solver preset; a
made-up kernel in the sources that HAND_KERNELS does not name stops the
tool and is refused in a trace, not dropped; a library kernel, also one
in an anonymous namespace, is left to the operators."""

import os
import re

import pytest

from flybody_tpu_torch.physics import engine
from flybody_tpu_torch.tools import profile_step as ps

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'flybody_tpu_torch', 'csrc')


def _globals():
    """(file, name) of every __global__ function, read token by token:
    the identifier before the first '(' after `void` and an optional
    __launch_bounds__(...)."""
    out = []
    for fn in sorted(os.listdir(CSRC)):
        if not fn.endswith('.cu'):
            continue
        src = open(os.path.join(CSRC, fn)).read()
        for m in re.finditer(r'__global__', src):
            rest = src[m.end():].lstrip()
            assert rest.startswith('void'), (fn, rest[:40])
            rest = rest[4:].lstrip()
            if rest.startswith('__launch_bounds__'):
                depth, i = 0, len('__launch_bounds__')
                while True:
                    depth += {'(': 1, ')': -1}.get(rest[i], 0)
                    i += 1
                    if depth == 0:
                        break
                rest = rest[i:].lstrip()
            out.append((fn, re.match(r'\w+', rest).group(0)))
    return out


GLOBALS = _globals()


def test_the_sources_hold_every_mapped_kernel_and_no_other():
    names = [n for _, n in GLOBALS]
    assert len(names) >= 20
    assert set(names) == set(ps.HAND_KERNELS)
    assert set(names) == ps.csrc_kernels()
    ps.check_map()


@pytest.mark.parametrize('fn,name', GLOBALS)
def test_each_kernel_maps_to_exactly_one_entry(fn, name):
    forms = [
        f'void (anonymous namespace)::{name}(float const*, int)',
        f'void (anonymous namespace)::{name}<2, false>('
        f'(anonymous namespace)::Args)',
        f'(anonymous namespace)::{name}<32>(float const*, float*, int)',
        f'_ZN12_GLOBAL__N_1{len(name)}{name}ILi2ELb0EEEvNS_4ArgsE',
        f'_ZN41_GLOBAL__N__0c467ba5_9_newton_cu_6a70d0a0{len(name)}{name}'
        f'ILi2ELb0EEEvNS_4ArgsE',
    ]
    for form in forms:
        assert ps._hand_kernel(form) == name, form
    # No other entry's name is a prefix or part that could claim it.
    assert sum(k == name for k in ps.HAND_KERNELS) == 1


@pytest.mark.parametrize('preset', sorted(engine.PRESETS))
def test_stage_weights_sum_to_one(preset):
    stages = {'position', 'collision', 'force', 'constraint_rows',
              'factor_solve', 'newton', 'noslip', 'sensors', 'euler'}
    for name in ps.HAND_KERNELS:
        w = ps.stage_weights(name, engine.PRESETS[preset])
        assert set(w) <= stages and w, name
        assert all(v > 0 for v in w.values()), name
        assert abs(sum(w.values()) - 1.0) < 1e-12, (name, w)


def test_an_unmapped_hand_kernel_is_refused_not_dropped():
    known = ps.csrc_kernels() | {'made_up_kernel'}
    for name in ('void (anonymous namespace)::made_up_kernel<1>('
                 '(anonymous namespace)::Args)',
                 '_ZN12_GLOBAL__N_114made_up_kernelEv'):
        with pytest.raises(KeyError, match='no stage'):
            ps._hand_kernel(name, known)
    # a substring of a mapped name is no match
    assert ps._hand_kernel('void (anonymous namespace)::mpr_kern('
                           'float const*)') is None
    # The pre-pass is not the MPR kernel, nor the reverse.
    assert ps._hand_kernel('void (anonymous namespace)::mpr_order_kernel('
                           'float const*, int, int*)') == 'mpr_order_kernel'
    assert ps._hand_kernel('void (anonymous namespace)::mpr_kernel<0, 0>('
                           'float const*)') == 'mpr_kernel'


def test_library_kernels_go_to_the_operators():
    for name in ('void at::native::vectorized_elementwise_kernel<4, '
                 'at::native::FillFunctor<float>, std::array<char*, 1ul> >'
                 '(int, at::native::FillFunctor<float>, std::array<char*, '
                 '1ul>)',
                 'void at::native::(anonymous namespace)::'
                 'indexSelectLargeIndex<float, long, unsigned int, 2, 2, '
                 '-2, true>(float*)',
                 'void (anonymous namespace)::elementwise_kernel_with_index'
                 '<int, at::native::arange_cuda_out(c10::Scalar const&)::'
                 '{lambda()#1}::operator()() const::{lambda(long)#1}>(int)',
                 'sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32',
                 'Memcpy DtoD (Device -> Device)'):
        assert ps._hand_kernel(name) is None, name


def test_a_new_kernel_without_a_stage_stops_the_tool(tmp_path):
    for fn in os.listdir(CSRC):
        if fn.endswith('.cu'):
            (tmp_path / fn).write_text(open(os.path.join(CSRC, fn)).read())
    (tmp_path / 'extra.cu').write_text(
        'namespace {\n__global__ void __launch_bounds__(128, 4)\n'
        '    extra_kernel(float* x) {}\n}  // namespace\n')
    with pytest.raises(ValueError, match='extra_kernel'):
        ps.check_map(str(tmp_path))
    with pytest.raises(KeyError, match='no stage'):
        ps._hand_kernel('void (anonymous namespace)::extra_kernel(float*)',
                        ps.csrc_kernels(str(tmp_path)))
