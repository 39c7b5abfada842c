from .engine import greedy_generate, make_decode_step, make_prefill
