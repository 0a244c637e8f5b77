"""FEM substrate of the port: mesh, constitutive law, operators, solvers, methods."""
