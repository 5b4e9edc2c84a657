"""Host data layer of the PyTorch port: datasets, augmentation, loaders."""
