"""Evaluation data: benchmark datasets, file clients, the MATLAB bicubic
and the test-time noise (numpy, as in image_restoration_tpu/data). The
training mixture and the device-side degradations come with the training
port."""
