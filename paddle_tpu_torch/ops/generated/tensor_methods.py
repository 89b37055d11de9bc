"""AUTO-GENERATED by `python -m paddle_tpu_torch.codegen` — DO NOT EDIT.
Source of truth: paddle_tpu_torch/ops/ops.yaml
"""


def bind_tensor_methods(Tensor):
    """Attach the schema-declared method surface onto Tensor."""
    import paddle_tpu_torch.ops.creation as ops_creation
    Tensor.empty_like = ops_creation.empty_like
    Tensor.full_like = ops_creation.full_like
    Tensor.ones_like = ops_creation.ones_like
    Tensor.tril = ops_creation.tril
    Tensor.triu = ops_creation.triu
    Tensor.zeros_like = ops_creation.zeros_like
    import paddle_tpu_torch.ops.generated.op_wrappers as ops_generated_op_wrappers
    Tensor.abs = ops_generated_op_wrappers.abs
    Tensor.add = ops_generated_op_wrappers.add
    Tensor.all = ops_generated_op_wrappers.all
    Tensor.amax = ops_generated_op_wrappers.amax
    Tensor.amin = ops_generated_op_wrappers.amin
    Tensor.any = ops_generated_op_wrappers.any
    Tensor.argmax = ops_generated_op_wrappers.argmax
    Tensor.argmin = ops_generated_op_wrappers.argmin
    Tensor.bmm = ops_generated_op_wrappers.bmm
    Tensor.broadcast_to = ops_generated_op_wrappers.broadcast_to
    Tensor.ceil = ops_generated_op_wrappers.ceil
    Tensor.clip = ops_generated_op_wrappers.clip
    Tensor.concat = ops_generated_op_wrappers.concat
    Tensor.cos = ops_generated_op_wrappers.cos
    Tensor.cumsum = ops_generated_op_wrappers.cumsum
    Tensor.divide = ops_generated_op_wrappers.divide
    Tensor.equal = ops_generated_op_wrappers.equal
    Tensor.erf = ops_generated_op_wrappers.erf
    Tensor.exp = ops_generated_op_wrappers.exp
    Tensor.expand = ops_generated_op_wrappers.expand
    Tensor.expand_as = ops_generated_op_wrappers.expand_as
    Tensor.expm1 = ops_generated_op_wrappers.expm1
    Tensor.flatten = ops_generated_op_wrappers.flatten
    Tensor.floor = ops_generated_op_wrappers.floor
    Tensor.floor_divide = ops_generated_op_wrappers.floor_divide
    Tensor.gather = ops_generated_op_wrappers.gather
    Tensor.greater_equal = ops_generated_op_wrappers.greater_equal
    Tensor.greater_than = ops_generated_op_wrappers.greater_than
    Tensor.index_select = ops_generated_op_wrappers.index_select
    Tensor.isfinite = ops_generated_op_wrappers.isfinite
    Tensor.isinf = ops_generated_op_wrappers.isinf
    Tensor.isnan = ops_generated_op_wrappers.isnan
    Tensor.less_equal = ops_generated_op_wrappers.less_equal
    Tensor.less_than = ops_generated_op_wrappers.less_than
    Tensor.log = ops_generated_op_wrappers.log
    Tensor.log10 = ops_generated_op_wrappers.log10
    Tensor.log1p = ops_generated_op_wrappers.log1p
    Tensor.log2 = ops_generated_op_wrappers.log2
    Tensor.logical_and = ops_generated_op_wrappers.logical_and
    Tensor.logical_not = ops_generated_op_wrappers.logical_not
    Tensor.logical_or = ops_generated_op_wrappers.logical_or
    Tensor.logsumexp = ops_generated_op_wrappers.logsumexp
    Tensor.masked_fill = ops_generated_op_wrappers.masked_fill
    Tensor.matmul = ops_generated_op_wrappers.matmul
    Tensor.max = ops_generated_op_wrappers.max
    Tensor.maximum = ops_generated_op_wrappers.maximum
    Tensor.mean = ops_generated_op_wrappers.mean
    Tensor.min = ops_generated_op_wrappers.min
    Tensor.minimum = ops_generated_op_wrappers.minimum
    Tensor.mod = ops_generated_op_wrappers.mod
    Tensor.multiply = ops_generated_op_wrappers.multiply
    Tensor.neg = ops_generated_op_wrappers.neg
    Tensor.not_equal = ops_generated_op_wrappers.not_equal
    Tensor.one_hot = ops_generated_op_wrappers.one_hot
    Tensor.pow = ops_generated_op_wrappers.pow
    Tensor.prod = ops_generated_op_wrappers.prod
    Tensor.reciprocal = ops_generated_op_wrappers.reciprocal
    Tensor.reshape = ops_generated_op_wrappers.reshape
    Tensor.round = ops_generated_op_wrappers.round
    Tensor.rsqrt = ops_generated_op_wrappers.rsqrt
    Tensor.scale = ops_generated_op_wrappers.scale
    Tensor.sign = ops_generated_op_wrappers.sign
    Tensor.sin = ops_generated_op_wrappers.sin
    Tensor.sqrt = ops_generated_op_wrappers.sqrt
    Tensor.square = ops_generated_op_wrappers.square
    Tensor.squeeze = ops_generated_op_wrappers.squeeze
    Tensor.stack = ops_generated_op_wrappers.stack
    Tensor.std = ops_generated_op_wrappers.std
    Tensor.subtract = ops_generated_op_wrappers.subtract
    Tensor.sum = ops_generated_op_wrappers.sum
    Tensor.tan = ops_generated_op_wrappers.tan
    Tensor.tanh = ops_generated_op_wrappers.tanh
    Tensor.tile = ops_generated_op_wrappers.tile
    Tensor.transpose = ops_generated_op_wrappers.transpose
    Tensor.trunc = ops_generated_op_wrappers.trunc
    Tensor.unsqueeze = ops_generated_op_wrappers.unsqueeze
    Tensor.var = ops_generated_op_wrappers.var
    import paddle_tpu_torch.ops.logic as ops_logic
    Tensor.is_complex = ops_logic.is_complex
    Tensor.is_empty = ops_logic.is_empty
    Tensor.is_floating_point = ops_logic.is_floating_point
    Tensor.is_integer = ops_logic.is_integer
    import paddle_tpu_torch.ops.manipulation as ops_manipulation
    Tensor.chunk = ops_manipulation.chunk
    Tensor.split = ops_manipulation.split
    Tensor.where = ops_manipulation.where
    import paddle_tpu_torch.ops.random as ops_random
    Tensor.normal_ = ops_random.normal_
    Tensor.uniform_ = ops_random.uniform_
