"""Parameter-efficient fine-tuning (LoRA)."""

from neuronx_distributed_training_torch.peft.lora import (  # noqa: F401
    LoraConfig,
    add_lora,
    merge_lora,
    trainable_mask,
)
