from .pipeline import (draw_batch_indices, padded_eval_batches,  # noqa: F401
                       place, sample_round_batches,
                       sample_round_token_batches)
from .synthetic import (ClusteredDataset, SynthSpec, apply_transform,  # noqa: F401
                        make_clustered_data)
from .tokens import TokenSpec, lm_batch, make_clustered_tokens  # noqa: F401
