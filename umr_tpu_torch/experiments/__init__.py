"""Entry points of the port: test_iou (mask IoU) and demo (panels)."""
