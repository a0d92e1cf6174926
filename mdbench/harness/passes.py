"""One pass of a cell's traffic through the program, and the window.

A pass is one user job: the cell's analyses, built anew on the
in-memory trajectory, streamed once through
``mdhelper_tpu_torch.analysis.multi.run_together`` in the traffic's
chunks, ending with the results on the host and the conclusions
included.  What the analyses are, their keyword arguments, the chunk and
which results are judged are all data in the traffic file.
"""

import importlib
import time

import numpy as np

#: keyword arguments the program takes as tuples (JSON gives lists).
TUPLES = ("range", "exclusion")


def resolved(entry, config):
    """The entry's keyword arguments with the configuration's values of
    its ``config_kwargs`` filled in and lists made tuples where the
    program wants them."""

    kwargs = dict(entry.get("kwargs", {}))
    for key in entry.get("config_kwargs", ()):
        kwargs[key] = config[key]
    for key in TUPLES:
        if isinstance(kwargs.get(key), list):
            kwargs[key] = tuple(kwargs[key])
    return kwargs


def build(universe, traffic, config, device, control=False):
    """The pass's analyses, in the traffic's order.  With `control`, each
    entry's ``control.kwargs`` (the program's own lower-precision path)
    are put over its keyword arguments."""

    analyses = []
    n_atoms = universe.atoms.n_atoms
    for entry in traffic["analyses"]:
        module, name = entry["class"].rsplit(".", 1)
        cls = getattr(importlib.import_module(
            f"mdhelper_tpu_torch.analysis.{module}"), name)
        kwargs = resolved(entry, config)
        if control:
            kwargs.update(entry.get("control", {}).get("kwargs", {}))
        analysis = cls(universe.atoms, verbose=False, device=device,
                       **kwargs)
        # The stream's chunk: the traffic's frames of float32 coordinates.
        analysis._chunk_bytes = traffic["chunk_frames"] * n_atoms * 3 * 4
        analyses.append(analysis)
    return analyses


def take(analyses, traffic):
    """The judged results of a finished pass, as host arrays: one dict an
    analysis, of the results its entry's ``take`` names."""

    return [{key: np.array(getattr(a.results, key)) for key in entry["take"]}
            for a, entry in zip(analyses, traffic["analyses"])]


def run_pass(universe, traffic, config, device, on_chunk=None,
             control=False, wrap=None, parallel=False):
    """Build and run one pass; returns its judged results.  `wrap`, when
    given, is called with the built analyses before the stream starts (the
    fault tests break the timed path through it).  With `parallel` the
    pass is sharded over the ranks of the default process group."""

    from mdhelper_tpu_torch.analysis.multi import run_together

    analyses = build(universe, traffic, config, device, control=control)
    if wrap is not None:
        wrap(analyses)
    run_together(analyses, on_chunk=on_chunk, parallel=parallel)
    return take(analyses, traffic)


def window(one_pass, seconds, sync):
    """Back-to-back passes from now until the end of the first pass that
    finishes `seconds` or more after the start: ``(results of every pass,
    passes, elapsed seconds, each pass's end in seconds from the
    start)``."""

    kept, ends = [], []
    start = time.perf_counter()
    while True:
        kept.append(one_pass())
        sync()
        ends.append(time.perf_counter() - start)
        if ends[-1] >= seconds:
            return kept, len(kept), ends[-1], ends
