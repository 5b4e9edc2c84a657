"""COCO and rotated-box evaluation of the PyTorch port."""
