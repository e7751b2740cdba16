from image_restoration_tpu_torch.models.registry import (  # noqa: F401
    KEY_MAPS, MODELS, get_model, register_model)
from image_restoration_tpu_torch.models import (  # noqa: F401
    adair, cg_ir, darkir, drsformer, hogformer, igmoce_ir, lsnet,
    lsnet_dense, lumisense_moe, measnet, moce_ir, moce_ir_patch, mwformer,
    nerd_rain, restormer, sfhformer, srconvnet, transweather, vig, vig_h)
