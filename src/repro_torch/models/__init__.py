from repro_torch.models.api import Model, UnsupportedFamilyError, build_model

__all__ = ["Model", "UnsupportedFamilyError", "build_model"]
