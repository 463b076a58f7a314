"""Preference alignment: DPO, ORPO and KTO (counterpart of the JAX package's
``alignment/``), with their pipeline hooks."""

from neuronx_distributed_training_torch.alignment.dpo import (  # noqa: F401
    compute_reference_logprobs,
    make_dpo_loss_fn,
)
from neuronx_distributed_training_torch.alignment.kto import (  # noqa: F401
    compute_reference_logprobs_kto,
    make_kto_loss_fn,
)
from neuronx_distributed_training_torch.alignment.losses import (  # noqa: F401
    dpo_loss,
    kto_loss,
    orpo_loss,
    sequence_logprobs,
)
from neuronx_distributed_training_torch.alignment.orpo import make_orpo_loss_fn  # noqa: F401
