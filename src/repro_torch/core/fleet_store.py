"""Where the (A, N) agent rows live: the fleet stores of the cohort-streamed
rounds (``fedsim/streaming``).

The resident engines hold the whole fleet as one device ``(A, N)``
buffer, so the card's memory bounds the fleet: at the paper MLP (N =
31,810) a million-agent fp32 fleet is 127 GB.  A fleet store abstracts
where the rows live:

* ``DeviceFleetStore``: the resident buffer on the device; ``gather`` and
  ``scatter`` are slices of it.
* ``HostFleetStore``: the fleet in host memory in the storage dtype (fp32
  or bf16, a CPU ``torch.Tensor`` either way), pinned when the rounds run
  on a card, so the copies to and from it are asynchronous DMA.  Only a
  round's agent chunks reach the device, so the device working set is
  O(chunk x N) whatever A is.

Stores are plain Python objects that hold tensors.  The streamed rounds
``gather`` a chunk, copy it to the device, run it, and ``scatter`` the
results back; ``scatter(..., where=)`` is the semi-async round's row-masked
write (busy agents keep their rows) without reading the old rows first.
Pinning that fails raises: a host store never falls back to pageable
memory, whose copies would be synchronous.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.flatten import resolve_storage_dtype

FLEET_STORES = ("device", "host")


def resolve_fleet_store(name: Optional[str]) -> str:
    """Canonical fleet-store spelling from a CLI / spec value."""
    if name is None:
        return "device"
    if name not in FLEET_STORES:
        raise ValueError(f"unknown fleet store {name!r} "
                         f"(want one of {FLEET_STORES})")
    return name


# the torch dtype of a store's rows from a fleet-dtype spelling or a dtype:
# fp32 or bf16, on the host as on the device (no numpy bridge dtype)
storage_dtype = resolve_storage_dtype


def _masked_copy(dst: torch.Tensor, rows: torch.Tensor, where) -> None:
    """dst = rows (cast to dst's dtype), or only the rows where ``where``
    (a (rows,) bool mask, tensor or array) is set; in place."""
    rows = rows.to(dst.dtype)
    if where is None:
        dst.copy_(rows)
        return
    keep = torch.as_tensor(where, dtype=torch.bool, device=dst.device)
    dst.copy_(torch.where(keep[:, None], rows, dst))


class DeviceFleetStore:
    """The resident (A, N) device buffer behind the store interface;
    ``gather`` returns a view, ``scatter`` writes in place."""

    kind = "device"

    def __init__(self, buffer: torch.Tensor):
        self._buf = buffer

    @classmethod
    def broadcast(cls, vec: torch.Tensor, n_agents: int, dtype,
                  device=None) -> "DeviceFleetStore":
        row = vec.to(device=device or vec.device, dtype=storage_dtype(dtype))
        # materialised, not an expand() view: scatter writes rows
        return cls(row.expand(n_agents, row.shape[-1]).clone())

    @classmethod
    def zeros(cls, n_agents: int, n: int, dtype,
              device=None) -> "DeviceFleetStore":
        return cls(torch.zeros((n_agents, n), dtype=storage_dtype(dtype),
                               device=device))

    @property
    def n_agents(self) -> int:
        return int(self._buf.shape[0])

    @property
    def n(self) -> int:
        return int(self._buf.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self._buf.dtype

    @property
    def nbytes(self) -> int:
        return self._buf.numel() * self._buf.element_size()

    def gather(self, lo: int, hi: int, col_lo: int = 0,
               col_hi: Optional[int] = None) -> torch.Tensor:
        """Rows [lo, hi), optionally only columns [col_lo, col_hi)."""
        return self._buf[lo:hi, col_lo:col_hi]

    def scatter(self, lo: int, rows: torch.Tensor, where=None,
                col_lo: int = 0) -> None:
        """Write ``rows`` at row ``lo`` and column ``col_lo``; with
        ``where``, only the rows it sets."""
        _masked_copy(self._buf[lo:lo + rows.shape[0],
                               col_lo:col_lo + rows.shape[1]],
                     rows.to(self._buf.device), where)

    def snapshot(self) -> torch.Tensor:
        return self._buf


class HostFleetStore:
    """The fleet as one host (A, N) tensor in the storage dtype, pinned
    when ``pin`` (the rounds run on a card).  ``gather`` returns a host
    view; ``scatter`` takes host rows (a device tensor is copied down
    first, synchronously) with an optional row mask.  Host memory bounds
    the fleet; the device never holds more than a chunk."""

    kind = "host"

    def __init__(self, buffer: torch.Tensor):
        if buffer.device.type != "cpu":
            raise ValueError(f"a host store holds a CPU tensor, got "
                             f"{buffer.device}")
        self._buf = buffer

    @classmethod
    def zeros(cls, n_agents: int, n: int, dtype, *,
              pin: bool = False) -> "HostFleetStore":
        # torch.zeros(pin_memory=True) raises where pinning fails
        return cls(torch.zeros((n_agents, n), dtype=storage_dtype(dtype),
                               pin_memory=pin))

    @classmethod
    def broadcast(cls, vec: torch.Tensor, n_agents: int, dtype, *,
                  pin: bool = False) -> "HostFleetStore":
        row = vec.detach().to(device="cpu", dtype=storage_dtype(dtype))
        buf = torch.empty((n_agents, row.shape[-1]), dtype=row.dtype,
                          pin_memory=pin)
        buf.copy_(row.expand_as(buf))
        return cls(buf)

    @property
    def n_agents(self) -> int:
        return int(self._buf.shape[0])

    @property
    def n(self) -> int:
        return int(self._buf.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self._buf.dtype

    @property
    def nbytes(self) -> int:
        return self._buf.numel() * self._buf.element_size()

    @property
    def pinned(self) -> bool:
        return self._buf.is_pinned()

    def gather(self, lo: int, hi: int, col_lo: int = 0,
               col_hi: Optional[int] = None) -> torch.Tensor:
        """Rows [lo, hi) as a host view; the optional column range keeps
        the two-axis round's transfers tile-sized."""
        return self._buf[lo:hi, col_lo:col_hi]

    def scatter(self, lo: int, rows: torch.Tensor, where=None,
                col_lo: int = 0) -> None:
        """Write ``rows`` at row ``lo`` and column ``col_lo``; with
        ``where``, only the rows it sets (torch ops on the host tensor, so
        bf16 rows need no numpy counterpart)."""
        _masked_copy(self._buf[lo:lo + rows.shape[0],
                               col_lo:col_lo + rows.shape[1]],
                     rows.to("cpu"), where)

    def snapshot(self) -> torch.Tensor:
        """The whole fleet (the host tensor itself): an eval / test
        boundary for small fleets; at streaming scale stay chunked."""
        return self._buf


def make_fleet_store(kind: str, vec: torch.Tensor, n_agents: int, dtype, *,
                     device=None):
    """A store of ``n_agents`` rows, each initialised to ``vec``: on
    ``device`` (default: vec's), or in host memory, pinned when ``device``
    is a card."""
    dev = torch.device(device) if device is not None else vec.device
    if resolve_fleet_store(kind) == "host":
        return HostFleetStore.broadcast(vec, n_agents, dtype,
                                        pin=dev.type == "cuda")
    return DeviceFleetStore.broadcast(vec, n_agents, dtype, device=dev)
