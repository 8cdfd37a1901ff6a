"""Scenes and frame streams made from a seed, on the device.

A configuration file fixes the scene: ``n``, the float type, and the
distributions of the centers and the radii. A traffic file fixes the
stream: ``frames`` frames, each the previous one with every center moved
by U(-s, s) per axis and reflected at the walls of the unit cube, where
``s`` is ``step_of_mean_radius`` times the scene's mean radius. The radii
stay fixed. The same seed gives the same frames on the same device.

Distributions (the ``dist`` key):

- ``uniform``: U(low, high); ``high_sqrt_n`` gives high = value / sqrt(n).
- ``pareto``: the power-law radii of the JAX package's mixed-radii scene
  (benchmarks/exp_r5.py:60-65): ``scale`` * (Lomax(``shape``) +
  ``offset``), clipped at ``clip``; ``scale_sqrt_n`` gives scale = value
  / sqrt(n).
"""

import math

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _scaled(spec, key, n):
    if key + "_sqrt_n" in spec:
        return spec[key + "_sqrt_n"] / math.sqrt(n)
    return spec[key]


def draw(spec, shape, n, dtype, gen, device):
    """One draw of ``shape`` from the distribution ``spec``."""
    if spec["dist"] == "uniform":
        low, high = spec.get("low", 0.0), _scaled(spec, "high", n)
        u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
        return low + (high - low) * u
    if spec["dist"] == "pareto":
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float64)
        lomax = (1.0 - u) ** (-1.0 / spec["shape"]) - 1.0
        r = _scaled(spec, "scale", n) * (lomax + spec.get("offset", 0.0))
        return r.clamp(0.0, spec["clip"]).to(dtype)
    raise ValueError(f"unknown distribution {spec['dist']!r}")


class Scene:
    """``radii`` [n] and ``frames``, a list of [n, 3] centers."""

    def __init__(self, radii, frames):
        self.radii = radii
        self.frames = frames

    @property
    def n(self):
        return self.radii.shape[0]


def make_scene(config, traffic, seed, device):
    """The configuration's scene under the traffic's motion, from
    ``seed``: one draw for the centers and one for the radii on the
    device, then one draw a frame for its step."""
    n, dtype = config["n"], DTYPES[config["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    coords = draw(config["coords"], (n, 3), n, dtype, gen, device)
    radii = draw(config["radii"], (n,), n, dtype, gen, device)
    count = traffic["frames"]
    step = traffic["step_of_mean_radius"] * float(radii.double().mean())
    move = {"dist": "uniform", "low": -step, "high": step}
    frames = [coords]
    for _ in range(count - 1):
        c = frames[-1] + draw(move, (n, 3), n, dtype, gen, device)
        c = torch.where(c < 0, -c, c)
        frames.append(torch.where(c > 1, 2 - c, c).contiguous())
    return Scene(radii, frames)
