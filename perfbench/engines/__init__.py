"""The engines a configuration can be served by, one module each, found
by the configuration's ``engine`` key (``manifest.engine``)."""
