"""Data: the all-in-one training mixture and the benchmark datasets, file
clients, the MATLAB bicubic and the host-side test noise (numpy, as in
image_restoration_tpu/data); the device-side training noise and mixup
(``degradations.py``), the sampler and the loader (``pipeline.py``)."""
