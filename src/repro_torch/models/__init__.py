"""Model zoo of the port: the CTR models (``ctr``) and the LM zoo (``lm``)."""
