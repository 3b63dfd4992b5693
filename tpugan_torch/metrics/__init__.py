"""FID: the Fréchet distance and its InceptionV3 and VGG19 feature models."""
