# Copy of trinity_tpu/limits.py; only its imports name the port.
"""Hard limits and core constants.

Mirrors the reference's Trinity::Limits (trinity_limits.h:11-22) plus the
TPU-native tiling constants that shape every kernel in `trinity_tpu.ops`.
"""

# --- reference-compatible limits (trinity_limits.h:12-15) -------------------
MAX_PHRASE_SIZE = 16
MAX_QUERY_TOKENS = 8192
MAX_TERM_LENGTH = 64
MAX_POSITION = 1 << 14

# --- TPU tiling constants ----------------------------------------------------
# Postings block: 128 docs, like the lucene codec's BLOCK_SIZE
# (lucene_codec.h:49-57) — and exactly one TPU lane dimension.
BLOCK_SIZE = 128
# Window = one (128, 128) tile of the dense local-docid space; the TPU analog
# of the 8192-id evaluation windows in docset_spans.h:38-77 (SHIFT=13), grown
# to 2^14 so a window is a single MXU-shaped tile.
WINDOW_SHIFT = 14
WINDOW_SIZE = 1 << WINDOW_SHIFT  # 16384 = 128 * 128
TILE = 128

# Bit-plane packing caps.
MAX_DOC_BITS = 32
MAX_FREQ_BITS = 16  # freqs are clipped to 2^16 (tokenpos_t-sized, runtime.h:8-20)
PLANE_WORDS = BLOCK_SIZE // 32  # u32 words per bit plane (= 4)
# Upper bound of packed u32 words a single block can occupy.
MAX_BLOCK_WORDS = PLANE_WORDS * (MAX_DOC_BITS + MAX_FREQ_BITS)

# Sentinel: end of postings / docs set (common.h:41-43).
DOC_IDS_END = 0xFFFFFFFF

# Per-segment (and per-MeshExecutor collection) docid-space cap. Packed batch
# outputs carry local docids as f32 rows (executor._build_batch_combined,
# pruned-batch, mesh batch), which is exact only below 2^24; the reference
# serves full u32 docid spaces (common.h:28-43) — here the envelope is
# explicit: segments at or above this must be sharded (parallel/mesh.py).
MAX_SEGMENT_DOCS = 1 << 24
