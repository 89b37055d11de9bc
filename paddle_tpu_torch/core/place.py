"""Device places (counterpart of paddle_tpu/core/place.py).

A Place names a logical device; the concrete device is a
``torch.device``.  The default place is the card (``gpu:0``);
``set_device("cpu")`` asks for the CPU.  Without a card and without that
request, resolving the default place raises: there is no silent CPU
fallback.
"""
from __future__ import annotations

import torch

__all__ = [
    "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "set_device",
    "get_device", "get_all_device_type", "device_count",
    "current_torch_device", "is_compiled_with_cuda", "is_compiled_with_xpu",
    "is_compiled_with_rocm", "is_compiled_with_distribute",
]

_state = {"place": None}


class Place:
    """Base device identity: (device_type, device_id)."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def get_device_id(self) -> int:
        return self.device_id

    def torch_device(self) -> torch.device:
        raise NotImplementedError

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; call "
                "paddle_tpu_torch.set_device('cpu') to run on the CPU")
        return torch.device("cuda", self.device_id)


class CUDAPinnedPlace(CPUPlace):
    pass


def _parse_device(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace() if device.type == "cpu" else \
            CUDAPlace(device.index or 0)
    if not isinstance(device, str):
        raise TypeError(f"Cannot interpret device: {device!r}")
    name, _, idx = device.partition(":")
    idx = int(idx) if idx else 0
    name = name.lower()
    if name == "cpu":
        return CPUPlace()
    if name in ("gpu", "cuda"):
        return CUDAPlace(idx)
    raise ValueError(f"Unknown device type: {device!r}")


def set_device(device) -> Place:
    """Set the default device: 'gpu', 'gpu:1', 'cuda', 'cpu' or a Place."""
    place = _parse_device(device)
    _state["place"] = place
    return place


def _current_place() -> Place:
    place = _state["place"]
    return place if place is not None else CUDAPlace(0)


def get_device() -> str:
    p = _current_place()
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.device_id}"


def current_torch_device() -> torch.device:
    return _current_place().torch_device()


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def device_count(device_type: str | None = None) -> int:
    if device_type in (None, "gpu", "cuda"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n or device_type is not None:
            return n
    return 1


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return True
