"""Contrastive training of the CCFT query encoder (counterpart of
``repro.contrastive``)."""
from .finetune import (cosine_loss, finetune_categorical, make_category_pairs,
                       make_generic_pairs, pretrain_generic, train_step)

__all__ = ["cosine_loss", "finetune_categorical", "make_category_pairs",
           "make_generic_pairs", "pretrain_generic", "train_step"]
