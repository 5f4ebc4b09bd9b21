"""Host-side data: images, tokenizers, the VITON-HD and DressCode datasets."""
