"""Models (counterpart of paddle_tpu/models/): the decoder-only
transformer LM that the serving engine drives, and ResNet, the CRNN OCR
model and the CTR models (Wide&Deep, DeepFM) built on the port's Fluid
layers (`resnet.py`, `ocr_crnn.py`, `ctr.py`)."""
