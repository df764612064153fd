"""Architecture configurations of the PyTorch port (counterpart of
``repro.configs``): the dataclasses and the registry, and the two
configurations the serving slice runs."""
