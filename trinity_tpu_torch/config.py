# Copy of trinity_tpu/config.py; only its imports name the port.
"""Runtime configuration.

The reference's knobs are compile-time macros and Makefile switches
(SURVEY §5.6: LUCENE_ENCODING_SCHEME, TRINITY_* feature macros, block size,
skiplist strides). Here they are a runtime dataclass, overridable via
environment variables (TRINITY_TPU_<FIELD>) or programmatically via
`configure()`. Structural constants that define the on-disk/HBM format
(BLOCK_SIZE, WINDOW_SIZE, plane layout) live in limits.py and are format
versioned, not tunable per process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields


@dataclass
class Config:
    # executor
    # finer buckets: the dense tile tensor costs HBM bandwidth proportional
    # to PADDED B*T, so padding waste is wall-clock (measured ~2.7x on the
    # bench AND group); the persistent compile cache absorbs the variants
    batch_buckets: tuple = (1, 2, 4, 8, 12, 16, 24, 32, 36, 48, 64)
    term_buckets: tuple = (2, 4, 8, 16, 32, 64, 128)  # kernel term-axis padding
    phrase_candidate_cap: int = 2048  # initial per-window phrase candidates
    phrase_lazy_candidates: int = 8192  # bound-ordered pull (lazy phrase path)
    # the lazy C2 ladder keeps growing past phrase_lazy_candidates (sparse
    # x4 rungs) until it covers the group's min-member df, so stopword
    # bigrams stay on the lazy path (flat device verify) instead of the
    # dense positional fallback (measured 100-277 ms/query, r4); this
    # bounds the growth — groups needing more overflow like before
    phrase_lazy_max_candidates: int = 1 << 21
    rich_candidate_cap: int = 2048  # initial rich-match candidates
    default_k: int = 10
    default_scorer: str = "bm25"
    # hot-term plane cache (ops/fusedscore.py cached slots): terms with
    # df >= hot_cache_min_df get their dense frequency planes precomputed
    # once per executor ((W, 128, 128) f32 per term, highest-df first,
    # bounded by hot_cache_bytes); a cached slot's tile arrives as ONE
    # (128, 128) DMA instead of the per-(query, window) block decode whose
    # cost is linear in df (a df~1M term measured ~22 us/window to decode).
    # 0 bytes disables. Values are the same f32 freqs the decode produces,
    # so results are bit-identical.
    hot_cache_bytes: int = 768 << 20
    hot_cache_min_df: int = 4096
    # dense positional-presence phrase path (ops/posmask.py): per-doc
    # position BITMASKS (PW u32 words) let phrase frequency be computed as
    # popcount(AND of member masks shifted by their phrase offset) — an
    # exact dense evaluation whose per-query cost is O(n_docs * PW)
    # elementwise work plus a scatter linear in the members' postings,
    # instead of the candidate ladder's O(min_df * fcap^2) gather/verify
    # (the r4 bench measured stopword bigrams at ~22 ms/query on the
    # ladder). Applies when the segment's max position < 32*posmask_max_words
    # and its positions are distinct per (term, doc) — else the ladder runs.
    use_posmask: bool = True
    posmask_max_words: int = 4  # PW cap: positions < 32*PW use the path
    # posmask hot cache: terms with df >= posmask_min_df get their position
    # bitmask planes ((W, PW, 128, 128) i32 per term) precomputed once per
    # executor, bounded by posmask_cache_bytes — a cached member skips the
    # per-query scatter entirely (a df~1M member's scatter measures ~ms-
    # scale; its cached planes stream at HBM bandwidth). 0 disables.
    posmask_cache_bytes: int = 1 << 30
    posmask_min_df: int = 32768
    # host
    use_native: bool = True  # libtrinity_host.so if built
    # HBM residency budget for many-segment serving (exec/residency.py):
    # total device bytes of segment arrays kept resident; 0 = unlimited
    # (every executor stays uploaded, the single-segment serving default)
    hbm_budget_bytes: int = 0
    # persistent COMPILED-executable cache (utils/aotcache.py): absorbs the
    # per-process remote-compile bill on backends whose XLA persistent cache
    # misses Mosaic kernels. Empty string = disabled (tests, CPU runs).
    aot_cache_dir: str = ""

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in fields(cls):
            env = os.environ.get(f"TRINITY_TPU_{f.name.upper()}")
            if env is None:
                continue
            cur = getattr(cfg, f.name)
            if isinstance(cur, bool):
                setattr(cfg, f.name, env.lower() in ("1", "true", "yes"))
            elif isinstance(cur, int):
                setattr(cfg, f.name, int(env))
            elif isinstance(cur, tuple):
                setattr(cfg, f.name, tuple(int(x) for x in env.split(",")))
            else:
                setattr(cfg, f.name, env)
        return cfg


_config = Config.from_env()


def get_config() -> Config:
    return _config


def configure(**kw) -> Config:
    """Override runtime knobs process-wide; returns the active config."""
    for k, v in kw.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(_config, k, v)
    return _config
