from image_restoration_tpu_torch.models.registry import MODELS, get_model, register_model  # noqa: F401
from image_restoration_tpu_torch.models import restormer  # noqa: F401
