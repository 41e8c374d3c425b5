"""Host/device mirrored buffer — the memory substrate.

Counterpart of ``unitysimpleraytracing_tpu/core/buffer.py`` and analog of the
reference's ``DataBuffer<T>`` (``Assets/_Scripts/DataBuffer.cs:5-76``): a
device tensor paired with a host numpy mirror and a dirty flag.  ``sync()``
uploads pending host writes (DataBuffer.cs:56-60), ``get_data()`` downloads
(:50-54), and reading an index lazily downloads first (:32-48).  The
constructor's fill-with-initial-value mode reproduces the sentinel pre-fill
the pipeline relies on (keys = 0xFFFFFFFF so padding sorts last, node links =
null sentinels; MeshBufferContainer.cs:108-115).

The "upload" is a copy of the mirror to the buffer's device and the
"download" a copy back; the two never share memory, also when the device is
the CPU.  The pipeline itself never uses this class (plain tensors are the
fast path); it exists for host-driven orchestration, debugging and
incremental scene editing, the same role DataBuffer plays for the C# host.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from unitysimpleraytracing_tpu_torch.utils.device import resolve_device


class DataBuffer:
    """A device tensor with a lazily-synchronized host mirror.  ``device=None``
    means the card and raises without one."""

    def __init__(
        self,
        count: int,
        dtype: Any = np.float32,
        shape_suffix: tuple[int, ...] = (),
        initial_value: Any = None,
        device=None,
    ):
        self._torch_device = resolve_device(device)
        self._host = np.zeros((count, *shape_suffix), dtype)
        if initial_value is not None:
            self._host[...] = initial_value
        self._device = None
        self._host_dirty = True    # host has writes not yet uploaded
        self._device_dirty = False  # device has results not yet downloaded

    # -- shape/metadata ------------------------------------------------------
    @property
    def count(self) -> int:
        return self._host.shape[0]

    @property
    def dtype(self):
        return self._host.dtype

    @property
    def shape(self) -> tuple[int, ...]:
        return self._host.shape

    @property
    def device(self) -> torch.device:
        return self._torch_device

    # -- transfers (DataBuffer.cs:50-60) --------------------------------------
    def sync(self) -> "DataBuffer":
        """Upload the host mirror to the device if it has pending writes."""
        if self._host_dirty or self._device is None:
            self._device = torch.from_numpy(self._host).to(self._torch_device, copy=True)
            self._host_dirty = False
            self._device_dirty = False
        return self

    def get_data(self) -> np.ndarray:
        """Download device contents into the host mirror and return it."""
        if self._device_dirty and self._device is not None:
            # A copy: the mirror must stay writable and apart from the tensor.
            self._host = np.array(self._device.detach().cpu().numpy())
            self._device_dirty = False
        return self._host

    @property
    def device_array(self) -> torch.Tensor:
        """The device-resident tensor (uploading first if host is newer)."""
        self.sync()
        return self._device

    def assign_device(self, tensor: torch.Tensor) -> "DataBuffer":
        """Point the buffer at a new device result (e.g. an op's output);
        marks the host mirror stale — the lazy-download path of the indexer."""
        if tuple(tensor.shape) != self._host.shape:
            raise ValueError(f"shape {tuple(tensor.shape)} != buffer {self._host.shape}")
        if tensor.device.type != self._torch_device.type:
            raise ValueError(f"tensor is on {tensor.device}, buffer on {self._torch_device}")
        self._device = tensor
        self._device_dirty = True
        self._host_dirty = False
        return self

    # -- element access (DataBuffer.cs:32-48) ----------------------------------
    def __getitem__(self, idx):
        return self.get_data()[idx]

    def __setitem__(self, idx, value) -> None:
        self.get_data()  # fold in any device results before mutating
        self._host[idx] = value
        self._host_dirty = True

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        state = "host-dirty" if self._host_dirty else (
            "device-dirty" if self._device_dirty else "clean"
        )
        return f"DataBuffer(shape={self._host.shape}, dtype={self.dtype}, {state})"
