from .results import append_result_row
from .seeding import make_generator, set_seed

__all__ = ["append_result_row", "make_generator", "set_seed"]
