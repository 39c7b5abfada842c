from .adamw import AdamWConfig, OptState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule
