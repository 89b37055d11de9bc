"""TensorArray ops (counterpart of paddle_tpu/ops/array.py): in eager
mode a tensor array is a Python list, as in the reference's dygraph
branches; under ``capture_step`` the list is resolved while the step is
captured, one element tensor at a time."""
from __future__ import annotations

from ..core.tensor import Tensor

__all__ = ["create_array", "array_write", "array_read", "array_length",
           "array_pop"]


def _index(i) -> int:
    """An int or a one-element int Tensor (read on the host)."""
    if isinstance(i, Tensor):
        flat = i.numpy().reshape(-1)
        if flat.size != 1:
            raise ValueError(
                f"array index must have a single element, got shape "
                f"{tuple(i.shape)}")
        return int(flat[0])
    return int(i)


def create_array(dtype="float32", initialized_list=None):
    """A new tensor array, optionally holding the given tensors."""
    if initialized_list is None:
        return []
    if not isinstance(initialized_list, (list, tuple)):
        raise TypeError(
            f"initialized_list must be list/tuple, got "
            f"{type(initialized_list).__name__}")
    return list(initialized_list)


def array_write(x, i, array=None):
    """Write x at position i; i == len appends."""
    idx = _index(i)
    if array is None:
        array = []
    if idx > len(array):
        raise IndexError(
            f"array_write index {idx} out of range for array of length "
            f"{len(array)} (writes may extend by at most one)")
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array, i):
    """The element at position i."""
    return array[_index(i)]


def array_length(array):
    """The number of elements."""
    return len(array)


def array_pop(array, i=-1):
    """Remove and return element i."""
    return array.pop(_index(i))
