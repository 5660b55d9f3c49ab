from tracklab_torch.wrappers.jersey.ocr_api import JerseyNumberOCR  # noqa
