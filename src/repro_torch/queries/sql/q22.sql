with cs as (
    select c_custkey, c_acctbal, c_phone_cc
    from customer
    where c_phone_cc in (13, 31, 23, 29, 30, 18, 17)
)
select c_phone_cc, count(*) as numcust, sum(c_acctbal) as totacctbal
from cs
where c_acctbal > (select avg(c_acctbal) from cs where c_acctbal > 0.0)
  and not exists (select o_orderkey from orders where o_custkey = c_custkey)
group by c_phone_cc
order by c_phone_cc
