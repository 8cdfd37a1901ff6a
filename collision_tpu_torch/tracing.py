"""The port's spans and counters.

Spans: :func:`span` opens a ``torch.profiler.record_function`` named
``ct.<layer>`` while a profiler is recording, and a shared no-op
otherwise, so any ``torch.profiler`` session sees each frame's layers
on the clock of the device and runtime events, and a frame outside one
pays for a flag check. The spans, from the entry down:

- ``ct.get_collisions`` (``Collider.get_collisions``), ``ct.retry``
  (its retry ladder; each rung is a ``ct.collide`` inside it);
- ``ct.collide``: one whole ``collide`` call;
- ``ct.probe``: ``auto``'s radius probe;
- ``ct.slab.plan``, ``ct.slab.sweep``, ``ct.slab.residual``,
  ``ct.slab.emit``: the slab engine's plan, sweep kernel (and row
  popcounts), residual jobs and emission;
- ``ct.column.plan``, ``ct.column.sweep``, ``ct.column.residual``,
  ``ct.column.emit``: the column engine's;
- ``ct.grid.bins``, ``ct.grid.counts``, ``ct.grid.emit``: the grid
  engine's bins, tile counts (or count) and emission;
- ``ct.hetero.split``, ``ct.hetero.big``: the hetero engine's split and
  its big-sphere passes (its S-S pass opens the slab or column spans);
- ``ct.runfill``: the run-expansion fill.

Counters, always on (a dict increment each):

- ``LAUNCHES``: hand-written kernel launches, by wrapper;
- ``HOST_SYNCS``: the points where the host waits for the device, by
  site: a device constant made from a host value, a device value read
  on the host, an input copied to the device. Counted on any device, so
  a CPU run counts what the same route waits for on the card, but for
  the slab and column plans: the CPU's plain paths count six and five,
  the card's kernel chains wait for none;
- ``ATTEMPTS``: engine runs, by engine; a ``Collider.get_collisions``
  frame whose first attempt holds makes one, each retry rung one more;
- ``PLANS``: column plans built, by builder: ``"engine"`` for a plan a
  ``collide`` attempt builds, ``"retry"`` for one the retry ladder
  builds for its statistics alone.

:func:`reset` zeroes all four.
"""

import collections
import contextlib
import functools

import torch
import torch.profiler

#: Kernel launches per wrapper. Each wrapper adds one where it launches
#: its kernel and nowhere else, so a run can show which kernels its main
#: path went through.
LAUNCHES = {"slab_count": 0, "slab_masks": 0, "compact_mask": 0,
            "sweep_count_rolled": 0, "sweep_count_aligned": 0,
            "sweep_masks": 0, "big_count": 0, "big_pairs": 0,
            "pair_emit": 0, "halo_count": 0, "batched_count": 0,
            "grid_tile_counts": 0, "grid_emit": 0, "diag_count": 0,
            "row_popcounts": 0, "grid_bins": 0, "slab_plan": 0,
            "column_plan": 0}

#: Host syncs per site (``module.function``).
HOST_SYNCS = collections.Counter()

#: Engine runs per engine ("slab", "column", "hetero", "grid",
#: "runfill"), whether ``collide`` or the retry ladder starts them.
ATTEMPTS = collections.Counter()

#: Column plans built per builder ("engine", "retry").
PLANS = collections.Counter()

_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A ``record_function`` span ``name`` while a profiler records,
    else one shared no-op context manager."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name):
    """Decorator: run the function inside :func:`span` ``name``; with no
    profiler recording it calls the function straight through."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def host_sync(site, n=1):
    """Count ``n`` host syncs at ``site``: called beside every operation
    on a frame's path that makes the host wait for the device on the
    card, whatever the device of this run."""
    HOST_SYNCS[site] += n


def reset():
    """Zero ``LAUNCHES`` and clear ``HOST_SYNCS``, ``ATTEMPTS`` and
    ``PLANS``."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    HOST_SYNCS.clear()
    ATTEMPTS.clear()
    PLANS.clear()
