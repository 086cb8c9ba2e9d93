"""Launch package (the counterpart of ``repro.launch``): the serve
driver.  The reference's train driver, production mesh and dry-run come
with later slices."""
