"""Seeded random weights, made by the benchmark on the device.

One flat normal draw from a generator on the device, seeded from the run's
seed, is cut into the leaves in the order of the reference's parameter
list and scaled by the rule of the model family (``init`` of
``families/<family>.py``). The same seed gives the same tensors, so the program's weights are filled in place at set-up and the
reference draws its own copy again after the program's state is freed.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@torch.no_grad()
def draw(specs: list[tuple[str, tuple]], rule, seed: int, device,
         into: dict | None = None) -> dict:
    """The leaves of ``specs`` (name, shape), in order, from one draw on
    ``device`` scaled by ``rule(name, shape, z)``: written into the tensors
    of ``into`` (by name) where given, else returned as new f32 tensors."""
    total = sum(math.prod(s) for _, s in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out = {} if into is None else into
    off = 0
    for name, shape in specs:
        n = math.prod(shape)
        z = flat[off:off + n].view(shape)
        value = rule(name, tuple(shape), z)
        if into is None:
            out[name] = value.clone() if value.data_ptr() == z.data_ptr() \
                else value
        else:
            out[name].copy_(value)
        off += n
    del flat
    return out
