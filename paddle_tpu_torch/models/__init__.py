"""Models (counterpart of paddle_tpu/models/): the decoder-only
transformer LM that the serving engine drives, and ResNet and the CRNN
OCR model built on the port's Fluid layers (`resnet.py`,
`ocr_crnn.py`)."""
