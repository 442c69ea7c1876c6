"""A single-controller device mesh: the port's stand-in for
``jax.sharding.Mesh`` and the collectives of ``jax.shard_map``.

The JAX package runs its multi-device solvers as one program over a named
``Mesh``: inside ``shard_map`` every device holds its block of each array
and talks to the others through ``ppermute``, ``psum`` and ``all_gather``.
Here one Python process drives the mesh.  A ``Sharded`` value is the list
of its per-shard tensors, each on its shard's device; a per-shard step is
a loop over the shards, and the collectives are copies and ordered sums:

  * ``ppermute``: each destination shard receives its source's block
    (a copy when the two shards sit on different cards, the block itself
    when they share one); shards that receive nothing get zeros, as in JAX;
  * ``psum``: the shards' partials added in shard order, in their dtype,
    so the result is the same from run to run;
  * ``all_gather``: the blocks concatenated in shard order.

A value that is the same on every shard (a ``psum`` over the whole mesh,
an ``all_gather``, a replicated MG level) is one tensor on the mesh's
first device; a shard on another card reads it through a copy.  Shards may
repeat a device: one card then holds all P shards and runs them one after
another.  ``torch.distributed`` has no counterpart of this: NCCL refuses
two ranks on one card, so a multi-process group on one H100 would have a
single rank and never exercise a halo.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["PartitionSpec", "P", "Mesh", "make_mesh", "Sharded", "smap",
           "shard", "unshard", "axis_index", "axis_size", "ppermute",
           "ring_halos", "psum", "all_gather"]


class PartitionSpec(tuple):
    """Which mesh axis splits each array dimension (None: not split), as
    ``jax.sharding.PartitionSpec``; ``P()`` is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


class Mesh:
    """Devices on named axes: ``Mesh(devices, ("z",))`` or, for a 2D mesh,
    an array of shape (nz, ny) with ``("z", "y")``.  ``shape[name]`` is the
    axis' size; shards are numbered row-major over the axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.size = arr.size
        self.device_list = list(arr.reshape(-1))

    @property
    def home(self) -> torch.device:
        """The device that holds replicated values (shard 0's)."""
        return self.device_list[0]

    def coords(self, i: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(i, self.devices.shape))

    def flat(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.devices.shape))

    def _axis(self, axis_name: str) -> int:
        if axis_name not in self.shape:
            raise ValueError(f"no mesh axis {axis_name!r} in "
                             f"{self.axis_names}")
        return self.axis_names.index(axis_name)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.device_list})"


def make_mesh(shape, axis_names=("rows",), *, device=None) -> Mesh:
    """A mesh of ``shape`` shards (an int or a tuple, one size per axis).

    ``device``: None or "cuda" puts shard i on ``cuda:(i % count)`` (with
    one card, every shard on ``cuda:0``) and raises without a CUDA device;
    "cpu" puts every shard on the host; any other device holds them all.
    """
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(int(s)
                                                            for s in shape)
    n = int(np.prod(shape))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass "
                               "device='cpu' for a host mesh)")
        if dev.index is None:
            count = torch.cuda.device_count()
            devs = [torch.device("cuda", i % count) for i in range(n)]
        else:
            devs = [dev] * n
    else:
        devs = [dev] * n
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def _as_device(t, device):
    """``t`` on ``device``: the tensor itself when it is there already."""
    if isinstance(t, torch.Tensor) and t.device != device:
        return t.to(device)
    return t


class Sharded:
    """A global array held as per-shard blocks: ``shards[i]`` lies on
    ``mesh.device_list[i]``; ``spec`` says which mesh axis splits each
    dimension.  Arithmetic and indexing act shard by shard; a plain tensor
    or number on the other side is the same on every shard."""

    def __init__(self, mesh: Mesh, shards, spec: PartitionSpec):
        self.mesh = mesh
        self.shards = list(shards)
        self.spec = PartitionSpec(*spec)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{mesh.size}")

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def local_shape(self):
        return tuple(self.shards[0].shape)

    def map(self, fn: Callable, spec: Optional[PartitionSpec] = None):
        return smap(fn, self, spec=spec)

    def unshard(self) -> torch.Tensor:
        return unshard(self)

    def __getitem__(self, idx):
        return smap(lambda s: s[idx], self)

    def _binary(self, other, op):
        return smap(op, self, other)

    def __add__(self, o):
        return self._binary(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binary(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._binary(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binary(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binary(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binary(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._binary(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: b / a)

    def __neg__(self):
        return smap(lambda a: -a, self)

    def __repr__(self):
        return (f"Sharded({len(self.shards)} x {self.local_shape} "
                f"{self.dtype}, spec={self.spec})")


def smap(fn: Callable, *args, spec: Optional[PartitionSpec] = None):
    """``fn`` on each shard: Sharded arguments give their shard, tensors
    (replicated values) are moved to the shard's device, anything else is
    passed as it is.  The result is Sharded (``spec``: the first Sharded
    argument's unless given)."""
    first = next(a for a in args if isinstance(a, Sharded))
    mesh = first.mesh
    spec = first.spec if spec is None else spec
    return Sharded(mesh, [fn(*[a.shards[i] if isinstance(a, Sharded)
                               else _as_device(a, dev) for a in args])
                          for i, dev in enumerate(mesh.device_list)], spec)


def _blocks(size: int, parts: int, where: str):
    if size % parts:
        raise ValueError(f"{where}: size {size} not divisible by {parts} "
                         "shards")
    step = size // parts
    return [slice(j * step, (j + 1) * step) for j in range(parts)]


def shard(x, mesh: Mesh, spec: PartitionSpec) -> "Sharded | torch.Tensor":
    """Split a global array (tensor or numpy) over ``mesh`` by ``spec``
    (``P()``: replicated, returned as one tensor on the mesh's first
    device).  An already Sharded value is returned as it is."""
    if isinstance(x, Sharded):
        return x
    x = torch.as_tensor(x)
    spec = PartitionSpec(*spec)
    if not any(s is not None for s in spec):
        return x.to(mesh.home)
    shards = []
    for i, dev in enumerate(mesh.device_list):
        c = mesh.coords(i)
        idx = []
        for d, name in enumerate(spec):
            if name is None:
                idx.append(slice(None))
                continue
            a = mesh._axis(name)
            idx.append(_blocks(x.shape[d], mesh.devices.shape[a],
                               f"shard dim {d} over {name!r}")[c[a]])
        shards.append(x[tuple(idx)].to(dev).contiguous())
    return Sharded(mesh, shards, spec)


def unshard(x) -> torch.Tensor:
    """The global array of a Sharded value, on the mesh's first device (a
    tensor is returned as it is)."""
    if not isinstance(x, Sharded):
        return x
    mesh, spec = x.mesh, x.spec
    split = [(d, mesh._axis(n)) for d, n in enumerate(spec) if n is not None]
    # shards along the axes that split the array; index 0 on the others
    ranges = [range(mesh.devices.shape[a]) for _, a in split]
    blocks = {}
    for combo in itertools.product(*ranges):
        c = [0] * len(mesh.axis_names)
        for (_, a), j in zip(split, combo):
            c[a] = j
        blocks[combo] = _as_device(x.shards[mesh.flat(c)], mesh.home)

    def join(prefix, level):
        if level == len(split):
            return blocks[prefix]
        d = split[level][0]
        return torch.cat([join(prefix + (j,), level + 1)
                          for j in ranges[level]], dim=d)

    return join((), 0)


def axis_index(mesh: Mesh, axis_name: str) -> list:
    """Each shard's position along ``axis_name`` (``lax.axis_index``)."""
    a = mesh._axis(axis_name)
    return [mesh.coords(i)[a] for i in range(mesh.size)]


def axis_size(mesh: Mesh, axis_name: str) -> int:
    return mesh.shape[axis_name]


def _peer(mesh: Mesh, i: int, a: int, pos: int) -> int:
    c = list(mesh.coords(i))
    c[a] = pos
    return mesh.flat(c)


def ppermute(x: Sharded, axis_name: str, perm) -> Sharded:
    """``lax.ppermute``: along ``axis_name``, shard ``dst`` receives shard
    ``src``'s block for each (src, dst) in ``perm``; a shard that receives
    nothing gets zeros."""
    mesh = x.mesh
    a = mesh._axis(axis_name)
    src_of = {int(d): int(s) for s, d in perm}
    out = []
    for i, dev in enumerate(mesh.device_list):
        pos = mesh.coords(i)[a]
        if pos in src_of:
            out.append(_as_device(x.shards[_peer(mesh, i, a, src_of[pos])],
                                  dev))
        else:
            out.append(torch.zeros_like(x.shards[i]))
    return Sharded(mesh, out, x.spec)


def ring_halos(lo_slab: Sharded, hi_slab: Sharded, axis_name: str):
    """(low, high) halos from the ring neighbours along ``axis_name``:
    ``low`` is the previous shard's ``hi_slab``, ``high`` the next shard's
    ``lo_slab``; the global ends receive zeros.  This is the reference's
    pair of ring ``ppermute``s followed by ``jnp.where(idx == 0 / p - 1,
    0, ...)``: the wrap-around pairs are left out of ``perm``, so their
    shards receive ppermute's zeros and no block is copied in vain."""
    p = axis_size(lo_slab.mesh, axis_name)
    high = ppermute(lo_slab, axis_name, [(i, i - 1) for i in range(1, p)])
    low = ppermute(hi_slab, axis_name, [(i, i + 1) for i in range(p - 1)])
    return low, high


def psum(x: Sharded, axis_name) -> torch.Tensor:
    """``lax.psum`` over every axis of the mesh (one name, or a tuple of
    names): the shards' values summed in shard order, in their dtype, as
    one tensor on the mesh's first device."""
    mesh = x.mesh
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if sorted(axes) != sorted(mesh.axis_names):
        raise NotImplementedError(f"psum over {axes}: the port sums over "
                                  f"every mesh axis {mesh.axis_names}")
    acc = x.shards[0]
    for s in x.shards[1:]:
        acc = acc + _as_device(s, mesh.home)
    return acc


def all_gather(x: Sharded, axis_name: str, *, axis: int = 0) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` over the mesh's only axis: the
    blocks joined in shard order along ``axis``, as one tensor on the
    mesh's first device."""
    mesh = x.mesh
    if mesh.axis_names != (axis_name,):
        raise NotImplementedError("all_gather over one axis of a 1D mesh")
    return torch.cat([_as_device(s, mesh.home) for s in x.shards], dim=axis)
