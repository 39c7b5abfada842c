from .ops import flash_attention, flash_attention_trainable
from .ref import attention_ref
