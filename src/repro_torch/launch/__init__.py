"""Launch package (the counterpart of ``repro.launch``): the serve and
train drivers, the production mesh (``mesh``), the cells' input and
sharding specs (``specs``) and the dry runs of the model zoo
(``dryrun``) and of the paper's pencil FFT (``fft_dryrun``)."""
