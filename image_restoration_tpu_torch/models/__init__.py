from image_restoration_tpu_torch.models.registry import (  # noqa: F401
    KEY_MAPS, MODELS, get_model, register_model)
from image_restoration_tpu_torch.models import (  # noqa: F401
    adair, adaptir_edt, adaptir_ipt, cg_ir, darkir, demo_models, drsformer,
    fpn_restormer, hogformer, igmoce_ir, lsnet, lsnet_dense, lumisense_moe,
    measnet, moce_ir, moce_ir_patch, mwformer, mymodel, nerd_rain,
    rectiformer, restormer, sfhformer, srconvnet, transweather, vig, vig_h)
