"""Warmup coverage: the seal on the set of program variants a process ran.

Counterpart of the seal half of ``trinity_tpu/utils/aotcache.py`` (:34-64):
``seal_programs``, ``unseal_programs``, ``post_seal_misses`` and the
``aot.post_seal_miss`` counter. The reference serves any query shape with
zero compile cost (exec.cpp:662-666); a serving process recovers that by
warming every variant its workload touches and then sealing the set. On
the GPU nothing compiles per query shape, but first uses still cost: a
variant (``record``) is

  - the kernel library's build and bind (``utils/kernels.load``);
  - a hot-cache build (the executor's hot-term planes and posmask cache);
  - a launch shape warmup never ran: a group's route, batch rows and
    slots (with the tape for the tape routes, the posmask group's kernel
    columns, the phrase routes' C / C2 / fcap buckets), rich-match's
    (T, C), intersect's T.

After ``seal_programs()`` the first record of a new variant counts one
``aot.post_seal_miss``; with ``strict`` it raises ``RuntimeError("warmup
coverage hole: <variant>")``. Variants are recorded under a lock: warmup
runs its searches on a thread pool.
"""

from __future__ import annotations

import threading

from trinity_tpu_torch.utils.metrics import get_metrics

_lock = threading.Lock()
_seen: set = set()
_seal = {"sealed": False, "strict": False}


def seal_programs(strict: bool = False) -> None:
    """Declare the variant set complete (call after warmup)."""
    with _lock:
        _seal.update(sealed=True, strict=strict)


def unseal_programs() -> None:
    with _lock:
        _seal.update(sealed=False, strict=False)


def post_seal_misses() -> int:
    snap = get_metrics().snapshot().get("aot.post_seal_miss")
    return 0 if snap is None else int(snap["value"])


def forget_variants() -> None:
    """Forget every recorded variant, as a new process starts with none."""
    with _lock:
        _seen.clear()


def variants_recorded() -> int:
    """Distinct variants this process has recorded."""
    with _lock:
        return len(_seen)


def record(variant: tuple) -> None:
    """Note a use of `variant`; its first use after the seal is a miss."""
    with _lock:
        if variant in _seen:
            return
        sealed, strict = _seal["sealed"], _seal["strict"]
        if not strict:  # a strict miss stays a miss each time it recurs
            _seen.add(variant)
    if sealed:
        get_metrics().count("aot.post_seal_miss")
        if strict:
            raise RuntimeError(f"warmup coverage hole: {variant}")
