"""Language models of the port: layers and the dense transformer stack."""
