"""Exchanges between ranks of one host through a shared host segment.

The port's transport for the reference's ``all_gather`` and ``psum``
(whose own transport is XLA's) where the ranks of an axis share one card
under gloo: ``core/distributed.py`` sends a CUDA tensor's exchanges here
instead of through gloo's sockets. Each axis group maps one segment of
host memory (``SHM_DIR``), split into one slot a member and a flag word a
member; with a card it is registered once with ``cudaHostRegister``, so
the copies between the card and the slots are DMA, not staged through
pageable buffers or the caching host allocator.

One round of an exchange:

1. the rank copies its chunk from the card into its own slot and
   synchronises, then posts its flag;
2. it waits until every member has posted (a barrier on the flags);
3. it copies what it needs of every peer's slot straight into its place
   on the card (a gather: each part into the concatenated result; a
   reduce-scatter: only this rank's slice of each part, added in rank
   order), synchronises and posts again;
4. no slot is rewritten before every member has posted that second flag.

A tensor larger than a slot goes through in rounds of at most a slot, so
the segment's size is fixed whatever the tensor. The group's first member
creates the segment on the group's first exchange and sends its path to
the others once through the gloo group; every member maps it, and once
all have, it is unlinked, so no segment outlives a run or a killed rank.
A segment that cannot be made, mapped or registered raises
``SegmentError`` on every member, naming the path, its size and the
errno: there is no fallback to gloo's copy.

A gather is a copy, a reduce-scatter's sum and a two-rank sum are added
in rank order in the tensor's dtype: the bits of ``dist.all_gather``,
``slice_sum`` over a gather and ``dist.all_reduce`` of two ranks.
"""
from __future__ import annotations

import errno as errno_codes
import math
import mmap
import os
import tempfile
import time
import weakref
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SHM_DIR = "/dev/shm"
SLOT_BYTES = 32 << 20     # a member's slot: the most one round moves
WAIT_S = 300.0            # a member that has not posted by then fails it
FLAG_BYTES = 64           # a member's flag word, alone on its cache line
PAGE = 4096
SPINS = 64                # flag polls that yield before polls that nap
NAP_S = 20e-6


class SegmentError(RuntimeError):
    """A segment that could not be made, mapped or registered."""


def _os_error(what: str, path: str, size: int, e: OSError) -> str:
    code = errno_codes.errorcode.get(e.errno, "?")
    return (f"{what} of the shared segment {path} ({size} bytes) failed: "
            f"{e.strerror} (errno {e.errno}, {code})")


def _blocks(rows: int, cols: int, cap: int
            ) -> Iterator[Tuple[int, int, int, int]]:
    """The rounds of a [rows, cols] exchange of at most ``cap`` elements
    each, as (first row, end row, first column, end column): blocks of
    whole rows while a row fits, else pieces of one row."""
    if rows * cols == 0:
        return
    if cols <= cap:
        step = cap // cols
        for r in range(0, rows, step):
            yield r, min(rows, r + step), 0, cols
    else:
        for r in range(rows):
            for a in range(0, cols, cap):
                yield r, r + 1, a, min(cols, a + cap)


def _create(directory: str, size: int) -> Tuple[Optional[str], str]:
    """A new file of ``size`` bytes under ``directory``, its space
    reserved (a tmpfs that runs out raises here, not on a later write):
    (path, "") or (None, the error)."""
    path = os.path.join(directory, "repro_torch_shm_XXXXXX")
    try:
        fd, path = tempfile.mkstemp(prefix="repro_torch_shm_",
                                    dir=directory)
    except OSError as e:
        return None, _os_error("creation", path, size, e)
    try:
        os.posix_fallocate(fd, 0, size)
    except OSError as e:
        os.unlink(path)
        return None, _os_error("allocation", path, size, e)
    finally:
        os.close(fd)
    return path, ""


def _release(state: dict) -> None:
    """Unregister and unmap a segment (the registration first: a range
    still registered when unmapped could not be registered again)."""
    if state.get("registered"):
        torch.cuda.cudart().cudaHostUnregister(state["ptr"])
        state["registered"] = False
    for key in ("flags", "slots", "bytes"):
        state.pop(key, None)
    mm = state.pop("mm", None)
    if mm is not None:
        try:
            mm.close()
        except BufferError:     # a view still alive: unmapped when freed
            pass


class Segment:
    """One axis group's shared segment; every member of ``group``
    constructs it together (a collective). ``device``: the card whose
    tensors it will exchange (registered with it), None for the CPU."""

    def __init__(self, group, device=None, slot_bytes: int = SLOT_BYTES,
                 directory: str = SHM_DIR):
        self.group = group
        self.n = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.slot_bytes = max(PAGE, slot_bytes // PAGE * PAGE)
        self.header = math.ceil(self.n * FLAG_BYTES / PAGE) * PAGE
        self.size = self.header + self.n * self.slot_bytes
        self.round = 0
        msg = [None, ""]
        if self.index == 0:
            msg = list(_create(directory, self.size))
        dist.broadcast_object_list(msg, src=dist.get_global_rank(group, 0),
                                   group=group)
        path, err = msg
        if path is None:
            raise SegmentError(err)
        self.path = path
        self._state = {"registered": False}
        self._finalizer = weakref.finalize(self, _release, self._state)
        self._finalizer.atexit = False
        err = self._map(device)
        errors = [None] * self.n
        dist.all_gather_object(errors, err, group=group)
        if self.index == 0:
            os.unlink(path)
        failed = [f"member {i}: {e}" for i, e in enumerate(errors) if e]
        if failed:
            self.close()
            raise SegmentError("; ".join(failed))
        self.flags = self._state["flags"]
        self.slots = self._state["slots"]

    def _map(self, device) -> str:
        """Map the segment (and register it with the card): "" or the
        error."""
        try:
            fd = os.open(self.path, os.O_RDWR)
        except OSError as e:
            return _os_error("opening", self.path, self.size, e)
        try:
            mm = mmap.mmap(fd, self.size)
        except OSError as e:
            return _os_error("mapping", self.path, self.size, e)
        finally:
            os.close(fd)
        st = self._state
        st["mm"] = mm
        st["bytes"] = torch.frombuffer(mm, dtype=torch.uint8)
        st["ptr"] = st["bytes"].data_ptr()
        words = np.frombuffer(mm, dtype=np.int64,
                              count=self.header // 8)
        st["flags"] = words[::FLAG_BYTES // 8][:self.n]
        st["slots"] = st["bytes"][self.header:].view(self.n, self.slot_bytes)
        if device is not None and torch.device(device).type == "cuda":
            rt = torch.cuda.cudart()
            res = rt.cudaHostRegister(st["ptr"], self.size, 1)  # portable
            if res != rt.cudaError.success:
                return (f"cudaHostRegister of the shared segment {self.path} "
                        f"({self.size} bytes) failed: cudaError "
                        f"{int(res)} ({rt.cudaGetErrorString(res)})")
            st["registered"] = True
        return ""

    def close(self) -> None:
        """Unregister and unmap (also done when the segment is freed)."""
        self.flags = self.slots = None
        self._finalizer()

    # ---- the flags --------------------------------------------------------

    def _post(self, value: int) -> None:
        self.flags[self.index] = value

    def _wait(self, value: int) -> None:
        """Until every member's flag is at least ``value``."""
        flags, spins, deadline = self.flags, 0, None
        while flags.min() < value:
            spins += 1
            if spins <= SPINS:
                os.sched_yield()
                continue
            if deadline is None:
                deadline = time.monotonic() + WAIT_S
            elif time.monotonic() > deadline:
                late = [i for i in range(self.n) if flags[i] < value]
                raise TimeoutError(f"shared segment {self.path}: members "
                                   f"{late} did not reach round "
                                   f"{value / 2} in {WAIT_S} s")
            time.sleep(NAP_S)

    def _round(self, t: torch.Tensor, write, read) -> None:
        """One round: ``write()`` (into this member's slot) once every
        member has read the last round, ``read()`` (from the members'
        slots) once every member has written; each followed, for a CUDA
        ``t``, by a synchronise with the card's stream, so that a slot is
        done with when the flag goes up."""
        r = self.round
        self._wait(2 * r)
        write()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        self._post(2 * r + 1)
        self._wait(2 * r + 1)
        read()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        self._post(2 * r + 2)
        self.round = r + 1

    # ---- the exchanges ----------------------------------------------------

    def _cap(self, t: torch.Tensor, parts: int = 1) -> int:
        return self.slot_bytes // (t.element_size() * parts)

    def _view(self, i: int, t: torch.Tensor, start: int, shape):
        """Slot ``i`` as ``t``'s dtype from element ``start``, ``shape``."""
        n = math.prod(shape)
        return self.slots[i].view(t.dtype)[start:start + n].view(shape)

    @torch.no_grad()
    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The members' ``t`` concatenated on ``dim`` in their order, on
        ``t``'s device (``all_gather``; every member passes a tensor of
        one shape and dtype)."""
        t = t.contiguous()
        shape = list(t.shape)
        pre, cols = math.prod(shape[:dim]), math.prod(shape[dim:])
        shape[dim] *= self.n
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        out3, src = out.view(pre, self.n, cols), t.view(pre, cols)
        for r0, r1, a, b in _blocks(pre, cols, self._cap(t)):
            blk = (r1 - r0, b - a)

            def write():
                self._view(self.index, t, 0, blk).copy_(src[r0:r1, a:b],
                                                        non_blocking=True)

            def read():
                for i in range(self.n):
                    part = src[r0:r1, a:b] if i == self.index \
                        else self._view(i, t, 0, blk)
                    out3[r0:r1, i, a:b].copy_(part, non_blocking=True)
            self._round(t, write, read)
        return out

    @torch.no_grad()
    def reduce_scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This member's block along ``dim`` of the members' ``g`` summed
        in their order, in ``g``'s dtype, on ``g``'s device: each member
        writes its ``g`` with the members' blocks apart, and reads only
        its own block of each."""
        g = g.contiguous()
        shape = list(g.shape)
        size = shape[dim] // self.n
        shape[dim] = size
        pre, cols = math.prod(shape[:dim]), math.prod(shape[dim:])
        g3 = g.view(pre, self.n, cols)
        acc = torch.empty(shape, dtype=g.dtype, device=g.device)
        acc2, j = acc.view(pre, cols), self.index
        for r0, r1, a, b in _blocks(pre, cols, self._cap(g, self.n)):
            blk = (r1 - r0, b - a)
            k = blk[0] * blk[1]

            def write():
                self._view(self.index, g, 0, (self.n, *blk)).copy_(
                    g3[r0:r1, :, a:b].transpose(0, 1), non_blocking=True)

            def read():
                dst = acc2[r0:r1, a:b]
                for i in range(self.n):
                    part = g3[r0:r1, j, a:b] if i == j \
                        else self._view(i, g, j * k, blk).to(
                            g.device, non_blocking=True)
                    if i == 0:
                        dst.copy_(part)
                    else:
                        dst += part
            self._round(g, write, read)
        return acc

    @torch.no_grad()
    def sum_pair(self, t: torch.Tensor) -> torch.Tensor:
        """A two-member group's ``t`` added, member 0's first, in ``t``'s
        dtype, on ``t``'s device (``all_reduce``'s sum: one addition an
        element, the same bits on both)."""
        if self.n != 2:
            raise ValueError(f"sum_pair needs 2 members, not {self.n}")
        t = t.contiguous()
        out = torch.empty_like(t)
        src, dst = t.view(1, -1), out.view(1, -1)
        for _, _, a, b in _blocks(1, t.numel(), self._cap(t)):
            def write():
                self._view(self.index, t, 0, (b - a,)).copy_(
                    src[0, a:b], non_blocking=True)

            def read():
                peer = self._view(1 - self.index, t, 0, (b - a,)).to(
                    t.device, non_blocking=True)
                pair = (src[0, a:b], peer) if self.index == 0 \
                    else (peer, src[0, a:b])
                torch.add(*pair, out=dst[0, a:b])
            self._round(t, write, read)
        return out
