"""Tiny overrides of each cell for runs on the CPU's twins: a few short
clips, the same branch of the program as the card's cell takes."""

SEED = 2**31 + 12345

TINY = {
    "podcast256.full10s": {
        "traffic": {"clips_per_batch": 4, "clip_seconds": 0.1, "ring": 2,
                    "warmup_batches": 2, "trace_batches": 3},
        # four clips would take the unfused branch; the cell's 256 take
        # the fused one
        "config": {"step": {"fused": True}},
    },
    "effects48k.stereo64x10s": {
        "traffic": {"clips_per_batch": 2, "clip_seconds": 0.1, "ring": 2,
                    "warmup_batches": 2, "trace_batches": 3},
        # on the CPU "auto" is the float64 scan engine; "pallas" is the
        # kernels' twins, the card's path
        "config": {"call": {"backend": "pallas"}},
    },
}
