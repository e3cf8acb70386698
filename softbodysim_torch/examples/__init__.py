"""Drives of the port, one module each, run as ``python -m
softbodysim_torch.examples.<name> [options]``; every one takes ``--device``
(default: the card, ``cuda``) and exposes ``main(argv=None)``:

* ``checkpoint_resume`` -- save mid-run, resume in a fresh Engine, bit for
  bit the uninterrupted run;
* ``datagen`` -- a batch of randomized-stiffness scenes (default 4096)
  stepped as one, scene-steps/s and constraint projections/s;
* ``drop_bodies`` -- balls and cubes onto a box, an OBJ sequence;
* ``fit_materials`` -- an edge compliance recovered by gradient;
* ``mixed_dialect_world`` -- jacobi and xpbd bodies as two merged programs;
* ``mixed_materials`` -- three stiffnesses in one merged mesh;
* ``moving_collider`` -- a capsule swept through a row of balls;
* ``multi_client`` -- one PBD1 server, concurrent clients;
* ``reference_scenes`` -- the reference's scenes with the manager's stats
  line, optionally an HTML animation;
* ``textured_fumo`` -- a textured render mesh tetrahedralized, skinned and
  exported lit (needs the reference checkout in SOFTBODYSIM_REFERENCE);

and ``remote_session.sh``, a server and a client in two processes.
"""
