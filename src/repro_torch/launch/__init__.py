"""Launch package (the counterpart of ``repro.launch``): the serve and
train drivers.  The reference's production mesh and dry-run come with a
later slice."""
