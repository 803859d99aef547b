"""The model zoo of the port: configuration, layers and the serving
decode step (counterpart of the reference's ``repro.models``). So far it
runs DeepSeek-V3's MLA + dense-MLP layers; see :mod:`.model`."""
