"""Deterministic synthetic data streams (numpy), as the reference's."""
from repro_torch.data.pipeline import (Prefetcher, host_shard, to_device,
                                       memmap_token_batches, microbatch_rows,
                                       synthetic_image_batches,
                                       synthetic_label_batches,
                                       synthetic_lm_batches)
