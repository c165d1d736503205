from .seeding import make_generator

__all__ = ["make_generator"]
