from .process import ManagedApp

__all__ = ["ManagedApp"]
