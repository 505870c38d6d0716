"""Models (counterpart of paddle_tpu/models/): the decoder-only
transformer LM that the serving engine drives, and ResNet built on the
port's Fluid layers (`resnet.py`)."""
