from .accounting import CommLog  # noqa: F401
