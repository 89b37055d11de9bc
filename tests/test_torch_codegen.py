"""The port's op code generator (paddle_tpu_torch/codegen): run on the
port's ops.yaml it reproduces the checked-in generated files byte for
byte; it emits exactly the ops the port defines; the port's yaml is the
JAX package's with the module and kernel paths rewritten."""
from pathlib import Path

import paddle_tpu_torch as pp
from paddle_tpu.codegen.schema import load_schema as j_load
from paddle_tpu_torch.codegen import generate as G
from paddle_tpu_torch.codegen.schema import OpSpec, load_schema as p_load
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.generated import OP_REGISTRY
from _torch_threads import torch_threads  # noqa: F401


def test_generator_reproduces_the_checked_in_files():
    for path, text in G.targets().items():
        assert Path(path).read_text() == text, path
    assert G.generate_all(check=True) == len(OP_REGISTRY)


def test_yaml_is_the_references_with_port_paths():
    ref = {s.name: s for s in j_load()}
    got = {s.name: s for s in p_load()}
    assert set(ref) == set(got)
    for name, s in got.items():
        r = ref[name]
        assert s.module == r.module.replace("paddle_tpu.",
                                            "paddle_tpu_torch.", 1), name
        assert (s.kernel or "") == (r.kernel or "").replace(
            "paddle_tpu.", "paddle_tpu_torch.", 1), name
        assert [a.to_yaml() for a in s.args] == \
            [a.to_yaml() for a in r.args], name


def test_only_defined_ops_are_emitted():
    ported = {s.name for s in G.ported(p_load())}
    assert ported == set(OP_REGISTRY)
    for name, spec in OP_REGISTRY.items():
        if spec.kernel:
            assert callable(getattr(K, spec.kernel.partition(":")[2])), name
        else:
            assert callable(spec.resolve()), name
    # a kernel-driven op without a port kernel, or a hand-written op its
    # module lacks, is not emitted
    missing = [OpSpec("no_such_kernel", "paddle_tpu_torch.ops.generated."
                      "op_wrappers", [], kernel="paddle_tpu_torch.ops."
                      "kernels:no_such_kernel"),
               OpSpec("no_such_op", "paddle_tpu_torch.ops.math", [])]
    assert G.ported(missing) == []


def test_tensor_methods_are_bound():
    for name, spec in OP_REGISTRY.items():
        if spec.tensor_method:
            assert callable(getattr(pp.Tensor, name)), name
