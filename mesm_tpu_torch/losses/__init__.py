from .criterion import CriterionConfig, compute_losses

__all__ = ["CriterionConfig", "compute_losses"]
