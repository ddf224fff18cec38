from .checkpoint import (peek_pending_len, restore,  # noqa: F401
                         restore_round_state, save, save_round_state)
