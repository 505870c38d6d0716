"""Models (counterpart of paddle_tpu/models/): the decoder-only
transformer LM that the serving engine drives, and, built on the port's
Fluid layers, the image zoo (`lenet`, `vgg`, `alexnet`, `googlenet`,
`mobilenet`, `resnet`), the SSD detector (`ssd`), the CRNN OCR model
(`ocr_crnn`) and the CTR models (`ctr`: Wide&Deep, DeepFM)."""
