"""The safetensors format, read and written with torch and the standard
library (no ``safetensors`` package: a card host need not have one).

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (byte
range in the data section, optional ``__metadata__``: str -> str), then
the raw little-endian bytes.

``SafetensorsReader`` hands out one tensor at a time on the device asked
for. It reads each tensor's bytes with a positioned read: for the CPU into
the tensor it returns, for a card into one pinned staging buffer (as large
as the largest tensor read so far) that is copied to the card, so a 5 GB
UNet streams to the card with one tensor's bytes in host memory. (A memory
mapping with its pages dropped after each tensor kept the whole file
resident on a card host: PERF.md, the checkpoint IO entry.) ``load_file``
reads every tensor;
``save_file`` writes each tensor by value (a transposed view writes its
values, not its base buffer).
"""

from __future__ import annotations

import json
import math
import os
import struct
from collections.abc import Mapping
from typing import Dict

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}


class SafetensorsReader(Mapping):
    """A safetensors file as a read-only mapping name -> tensor on
    ``device``; each lookup reads the tensor anew. Close it (or use it in a
    ``with``) to close the file."""

    def __init__(self, path: str, device="cpu"):
        self.path = path
        self.device = torch.device(device)
        self._f = open(path, "rb", buffering=0)
        try:
            size = os.fstat(self._f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", self._read(0, 8))
            if 8 + n > size:
                raise ValueError(f"{path}: header of {n} bytes overruns the "
                                 f"{size}-byte file")
            header = json.loads(self._read(8, n))
        except BaseException:
            self._f.close()
            raise
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries = header
        self._staging = None
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                self.close()
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")
            begin, end = e["data_offsets"]
            want = math.prod(e["shape"]) * _itemsize(DTYPES[e["dtype"]])
            if end - begin != want or self._base + end > size:
                self.close()
                raise ValueError(f"{path}: {name} spans bytes {begin}-{end}, "
                                 f"expected {want} inside the file")

    def _read(self, offset: int, nbytes: int, into=None):
        """``nbytes`` at ``offset``, as bytes or into the uint8 tensor
        ``into`` (a read may return less than asked: loop)."""
        if into is None:
            data = os.pread(self._f.fileno(), nbytes, offset)
            if len(data) != nbytes:
                raise ValueError(f"{self.path}: file ends inside its header")
            return data
        view = memoryview(into.numpy()).cast("B")
        done = 0
        while done < nbytes:
            got = os.preadv(self._f.fileno(), [view[done:nbytes]],
                            offset + done)
            if got <= 0:
                raise ValueError(f"{self.path}: file ends inside a tensor")
            done += got
        return into

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.get_tensor(name)

    def __contains__(self, name) -> bool:
        return name in self._entries     # from the header, reading nothing

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._entries[name]["dtype"]]

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the reader's device, a copy that owns its
        memory."""
        if self._f.closed:
            raise ValueError(f"{self.path}: reader is closed")
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        device = self.device
        begin, end = e["data_offsets"]
        nbytes = end - begin
        if nbytes == 0 or device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
        if device.type == "cpu":
            out = torch.empty(nbytes, dtype=torch.uint8)
            return self._read(self._base + begin, nbytes, out).view(
                dtype).view(shape)
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = None
            self._staging = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=device.type == "cuda")
        buf = self._read(self._base + begin, nbytes, self._staging[:nbytes])
        # a synchronous copy: the staging buffer is reused by the next read
        return buf.view(dtype).view(shape).to(device)

    def close(self):
        self._f.close()
        self._staging = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, on ``device``."""
    with SafetensorsReader(path, device) as r:
        return {name: r.get_tensor(name) for name in r}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def save_file(tensors: Mapping, path: str) -> None:
    """Writes ``tensors`` (name -> tensor on any device, any strides) to
    ``path``, each by value. Tensors are laid out by descending item size,
    then name, after a header padded to 8 bytes, so every tensor is aligned
    to its item size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel() == 0:
                continue
            # the layout work on the tensor's device, then its bytes
            host = t.contiguous().cpu().reshape(-1)
            f.write(memoryview(host.view(torch.uint8).numpy()))
