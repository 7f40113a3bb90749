from . import se3  # noqa: F401
