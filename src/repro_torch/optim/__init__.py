# Optimizers: the paper trains with SGD (Eq. 4); the LM trainer uses AdamW
# with global-norm clipping and the cosine schedule.
from .optimizers import (AdamWState, OptState, SGDState, adamw,
                         apply_updates, clip_by_global_norm, cosine_schedule,
                         sgd, tree_leaves, tree_map)

__all__ = ["AdamWState", "OptState", "SGDState", "adamw", "apply_updates",
           "clip_by_global_norm", "cosine_schedule", "sgd", "tree_leaves",
           "tree_map"]
