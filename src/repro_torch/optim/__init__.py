# Optimizers: the paper trains with SGD (Eq. 4).  AdamW, global-norm
# clipping and the cosine schedule come with LM training (ROADMAP, port
# Queue 1, item 9).
from .optimizers import (OptState, SGDState, apply_updates, sgd, tree_leaves,
                         tree_map)

__all__ = ["OptState", "SGDState", "apply_updates", "sgd", "tree_leaves",
           "tree_map"]
