"""Random weights from the seed, made on the device in a few large draws.

Each entry of the reference network's state dict is drawn as
`reference.net.init_spec` says (the program's initializers' laws): one
uniform and one normal draw over all entries of that kind, sliced and
scaled a leaf at a time, the constants filled. The same state dict loads
into the program by name and into the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

from reference.net import PoseNet, init_spec


def make_state(net: PoseNet, prior: float, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    spec = init_spec(net, prior)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in net.state_dict().items()}
    sizes = {kind: sum(torch.Size(shapes[k][0]).numel() for k, (kd, _) in spec.items()
                       if kd == kind) for kind in ("uniform", "normal")}
    draws = {"uniform": torch.rand(sizes["uniform"], generator=generator, device=device),
             "normal": torch.randn(sizes["normal"], generator=generator, device=device)}
    offsets = {"uniform": 0, "normal": 0}
    state = {}
    for name, (kind, value) in spec.items():
        shape, dtype = shapes[name]
        if kind == "const":
            state[name] = torch.full(shape, value, dtype=dtype, device=device)
            continue
        n = torch.Size(shape).numel()
        flat = draws[kind][offsets[kind]:offsets[kind] + n]
        offsets[kind] += n
        if kind == "uniform":
            state[name] = ((2 * flat - 1) * value).reshape(shape)
        else:
            state[name] = (flat * value).reshape(shape)
    return state
