"""A fault planted in the data-parallel step underneath the timed path, which the comparison has to catch.

``no_exchange``: each rank's step skips the gradients' all-reduce over the
data group (``parallel/distributed.py`` ``all_reduce_gradients``), so every
rank updates its dense leaves from its own rows alone; the sparse rows'
gather is left as it is.
"""

from __future__ import annotations


def no_exchange(trainer) -> None:
    from torch_rechub_tpu_torch.parallel import distributed as pdist

    step = trainer.train_step

    def broken(*batch):
        exchange = pdist.all_reduce_gradients
        pdist.all_reduce_gradients = lambda parameters, group: None
        try:
            return step(*batch)
        finally:
            pdist.all_reduce_gradients = exchange

    trainer.train_step = broken


DP = {"no_exchange": no_exchange}
