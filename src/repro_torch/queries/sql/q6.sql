declare q6_date_lo date default date '1994-01-01'
    in (date '1993-01-01', date '1997-01-01');
declare q6_date_hi date default date '1995-01-01'
    in (date '1994-01-01', date '1998-01-01');
declare q6_disc_lo float default 0.05 in (0.01, 0.09);
declare q6_disc_hi float default 0.07 in (0.01, 0.09);
declare q6_qty int default 24 in (20, 30);
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= :q6_date_lo
  and l_shipdate < :q6_date_hi
  and l_discount >= :q6_disc_lo
  and l_discount <= :q6_disc_hi
  and l_quantity < :q6_qty
